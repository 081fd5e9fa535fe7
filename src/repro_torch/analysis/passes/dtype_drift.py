"""dtype-drift: the distance path is float32, everywhere, on purpose.

The port of ``repro.analysis.passes.dtype_drift``: the reference's numpy
rules (the port's snapshot and store are numpy) plus their torch forms.
Distance math was unified on f32 after a silent f64 widening made
host/device parity flap; the quantized arenas sharpen the discipline
instead of relaxing it — an accidental f16/bf16 cast in the distance
lane is a recall loss with no crash.  ``ALLOWED_DTYPES`` is exactly
``{"float32"}`` for arrays whose names mark them as distance-lane
values (vectors, queries, distances, norms, dot products).
Attribute/order-key arrays are f32-canonical at ingest and are out of
scope (they match no distance name).

Quantized-slab rules (the vec_dtype arenas):

- ``q_vectors``/``q_slab``-named arrays are *storage*, not distance
  math: creating or casting them to int8/bfloat16 is quantization and
  is allowed everywhere.
- a cast to float32 (``.astype(float32)``, ``.to(torch.float32)``,
  ``.float()``) of a quantized slab is *dequantization* and is only
  legal inside the fused-kernel scope (``kernels.gather_distance`` and
  its parity oracle ``kernels.ref``): a dequant anywhere else
  re-materializes the f32 slab in device memory, exactly the traffic
  the quantized mode exists to avoid.
- quantization ``scales`` stay f32: any non-f32 float cast/creation of
  a scale-named array is a finding (a bf16 scale is a silent precision
  loss in every dequantized row).

Flagged, in distance-path modules: a cast to a non-f32 float
(``.astype(...)``, ``.to(torch.float16|bfloat16|float64)``, ``.half()``,
``.bfloat16()``, ``.double()``) of a distance-named value, and
``zeros/full/empty/asarray/array`` (numpy or torch, and ``torch.tensor``
/ ``torch.as_tensor``) creations of distance-named targets with a
non-f32 float dtype.
"""
from __future__ import annotations

import ast
import re

from ..callgraph import ModuleFile, RepoIndex, dotted
from ..findings import Finding

NAME = "dtype-drift"
DESCRIPTION = "non-f32 dtypes on distance-path arrays"
SCOPE = (r"core\.(device_search|hop_reference|search|snapshot|store|"
         r"distributed)$|kernels\.(distance|gather_distance|ops|ref)$|"
         r"serve\.lifecycle$")

ALLOWED_DTYPES = {"float32"}
#: legal storage dtypes for quantized-slab-named arrays (the vec_dtype
#: arenas); casting INTO these is quantization, never drift
QUANT_STORAGE_DTYPES = {"int8", "bfloat16"}
#: modules where dequantizing a quantized slab back to f32 is legal —
#: the fused gather kernel (dequant happens in registers) and its
#: reference parity oracle.  Anywhere else, ``q_slab.astype(float32)``
#: re-materializes the f32 slab host/HBM-side and defeats the mode.
DEQUANT_SCOPE = re.compile(r"kernels\.(gather_distance|ref)$")

_DIST_RE = re.compile(
    r"(?:^|_)(?:vec|vectors?|dist|dists|query|queries|target|norm|norms|"
    r"dot|dots|res_d|sq_norms?|q2)(?:$|_|s$)",
    re.IGNORECASE,
)
_QSLAB_RE = re.compile(
    r"(?:^|_)q_?(?:vectors?|slabs?|vecs?)(?:$|_)|quantized", re.IGNORECASE,
)
_SCALE_RE = re.compile(r"(?:^|_)scales?(?:$|_)", re.IGNORECASE)
_BAD_DTYPES = {"float64", "float16", "bfloat16", "double", "half"}
_CREATE_CALLS = {"zeros", "ones", "full", "empty", "asarray", "array",
                 "ascontiguousarray", "full_like", "zeros_like",
                 "ones_like", "empty_like", "tensor", "as_tensor"}
#: dtype-named casts of a torch tensor
_CAST_METHODS = {"half": "float16", "bfloat16": "bfloat16",
                 "double": "float64", "float": "float32"}
_DTYPE_NAMES = (_BAD_DTYPES | ALLOWED_DTYPES | QUANT_STORAGE_DTYPES
                | {"int8", "int16", "int32", "int64", "uint8", "bool"})


def _dtype_name(node: ast.AST) -> str | None:
    """'float64' for np.float64 / jnp.float64 / 'float64' / float."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return {"float": "float64"}.get(node.id, node.id)
    return None


def _cast_dtype(call: ast.Call) -> str | None:
    """The target dtype of a cast call (``x.astype(dt)``, ``x.to(dt)`` or
    ``x.to(dtype=dt)``, ``x.half()``...), None for any other call."""
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr == "astype" and call.args:
        return _dtype_name(call.args[0])
    if attr in _CAST_METHODS and not call.args:
        return _CAST_METHODS[attr]
    if attr == "to":
        for kw in call.keywords:
            if kw.arg == "dtype":
                return _dtype_name(kw.value)
        for a in call.args:
            dt = _dtype_name(a)
            if dt in _DTYPE_NAMES:
                return dt
    return None


def _names_in(node: ast.AST) -> list[str]:
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.append(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.append(sub.attr)
    return out


def _is_distance_named(names: list[str]) -> bool:
    return any(_DIST_RE.search(n) for n in names)


def _is_qslab_named(names: list[str]) -> bool:
    return any(_QSLAB_RE.search(n) for n in names)


def _is_scale_named(names: list[str]) -> bool:
    return any(_SCALE_RE.search(n) for n in names)


def run(index: RepoIndex, files: list[ModuleFile]) -> list[Finding]:
    out: list[Finding] = []

    def flag(mf: ModuleFile, node: ast.AST, what: str, dt: str) -> None:
        out.append(Finding(
            pass_name=NAME, path=mf.rel, line=node.lineno,
            message=f"distance-path {what} cast/created as {dt} "
                    f"(allowed: {sorted(ALLOWED_DTYPES)})"))

    def flag_dequant(mf: ModuleFile, node: ast.AST) -> None:
        out.append(Finding(
            pass_name=NAME, path=mf.rel, line=node.lineno,
            message="host-side dequant: quantized slab cast to float32 "
                    "outside the fused-kernel scope (dequant belongs in "
                    "kernels.gather_distance / kernels.ref only)"))

    def flag_scale(mf: ModuleFile, node: ast.AST, dt: str) -> None:
        out.append(Finding(
            pass_name=NAME, path=mf.rel, line=node.lineno,
            message=f"quantization scales cast/created as {dt} "
                    f"(scales must stay float32)"))

    for mf in files:
        for node in ast.walk(mf.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            # x.astype(np.float64) / x.to(torch.float64) / x.double()
            # where x is distance-named
            dt = _cast_dtype(node)
            if dt is not None:
                names = _names_in(node.func.value)
                if _is_qslab_named(names):
                    # casting a quantized slab INTO int8/bf16 is
                    # quantization; casting it back to f32 is dequant and
                    # only the kernel scope may do that
                    if (dt == "float32"
                            and not DEQUANT_SCOPE.search(mf.module)):
                        flag_dequant(mf, node)
                    continue
                # scale rule only for a direct `scales.astype(...)` base:
                # a scale name buried in a larger expression (e.g. the
                # int8 row cast `rint(v / scales).astype(int8)`) is not a
                # cast OF the scales
                if (isinstance(node.func.value, (ast.Name, ast.Attribute))
                        and _is_scale_named(names)):
                    if dt in _BAD_DTYPES or dt in QUANT_STORAGE_DTYPES:
                        flag_scale(mf, node, dt)
                    continue
                if dt in _BAD_DTYPES and _is_distance_named(names):
                    flag(mf, node, "value", dt)
                continue
            if d is None or d.split(".")[-1] not in _CREATE_CALLS:
                continue
            dt = None
            for kw in node.keywords:
                if kw.arg == "dtype":
                    dt = _dtype_name(kw.value)
            if dt is None and len(node.args) >= 2:
                cand = _dtype_name(node.args[-1])
                if cand in _BAD_DTYPES or cand in ALLOWED_DTYPES:
                    dt = cand
            # creation is distance-lane if the source argument is
            # distance-named; assigned-target names are covered below
            names = _names_in(node.args[0]) if node.args else []
            if _is_qslab_named(names) and dt in QUANT_STORAGE_DTYPES:
                continue  # quantized storage creation, by design
            if _is_scale_named(names) and (
                    dt in _BAD_DTYPES or dt in QUANT_STORAGE_DTYPES):
                flag_scale(mf, node, dt)
                continue
            if dt not in _BAD_DTYPES:
                continue
            if _is_distance_named(names):
                flag(mf, node, "array", dt)
    # assignment targets need the Assign context: re-walk for
    # `dist_x = zeros(..., dtype=f64)` style creations
    for mf in files:
        for node in ast.walk(mf.tree):
            if not isinstance(node, ast.Assign):
                continue
            call = node.value
            if not isinstance(call, ast.Call):
                continue
            d = dotted(call.func)
            if d is None or d.split(".")[-1] not in _CREATE_CALLS:
                continue
            dt = None
            for kw in call.keywords:
                if kw.arg == "dtype":
                    dt = _dtype_name(kw.value)
            if dt is None and len(call.args) >= 2:
                dt = _dtype_name(call.args[-1])
            tnames: list[str] = []
            for t in node.targets:
                tnames.extend(_names_in(t))
            if _is_qslab_named(tnames) and dt in QUANT_STORAGE_DTYPES:
                continue
            if _is_scale_named(tnames) and (
                    dt in _BAD_DTYPES or dt in QUANT_STORAGE_DTYPES):
                flag_scale(mf, call, dt)
                continue
            if dt not in _BAD_DTYPES:
                continue
            if _is_distance_named(tnames):
                flag(mf, call, "array", dt)
    return sorted(set(out))
