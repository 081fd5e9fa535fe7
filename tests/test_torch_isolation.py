"""The port stands alone: importing its entry point loads neither ``jax``,
``ml_dtypes`` nor the JAX package ``repro``, and no source file of the
port (or ``chip_smoke.py``, or the port's examples) imports them."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_entry_point_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.launch.serve, repro_torch.core.device_search\n"
        "import repro_torch.kernels.gather_distance, repro_torch.kernels._build\n"
        "import repro_torch.serve.engine, repro_torch.models.model\n"
        "import repro_torch.kernels.flash_attention, repro_torch.kernels.rwkv6\n"
        "import repro_torch.models.mamba, repro_torch.models.moe\n"
        "import repro_torch.kernels.mamba_scan\n"
        "import repro_torch.serve.lifecycle, repro_torch.persist.faultfs\n"
        "import repro_torch.persist, repro_torch.persist.format\n"
        "import repro_torch.persist.checkpoint, repro_torch.persist.wal\n"
        "import repro_torch.persist.recovery\n"
        "import repro_torch.persist.replicate, repro_torch.serve.cluster\n"
        "import repro_torch.parallel, repro_torch.parallel.sharding\n"
        "import repro_torch.core.distributed, repro_torch.core.baselines\n"
        "import repro_torch.train, repro_torch.train.optimizer\n"
        "import repro_torch.train.train_loop, repro_torch.train.checkpoint\n"
        "import repro_torch.train.data, repro_torch.train.elastic\n"
        "import repro_torch.train.compress, repro_torch.train.pipeline\n"
        "import repro_torch.launch.train\n"
        "import repro_torch.analysis, repro_torch.analysis.__main__\n"
        "import repro_torch.analysis.passes, repro_torch.monitoring\n"
        "import repro_torch.parallel.logical, repro_torch.models.tuning\n"
        "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.roofline, repro_torch.launch.op_cost\n"
        "import repro_torch.launch.quant_roofline, repro_torch.launch.report\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not torch.distributed.is_initialized()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "examples").glob("*_torch.py"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"
