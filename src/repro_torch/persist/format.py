"""On-disk primitives for the durable index lifecycle (the port's copy of
``repro.persist.format``: the same bytes, so either package reads what the
other wrote).

A checkpoint is a *directory*: a versioned ``MANIFEST.json`` header plus one
standalone ``.npy`` file per array section.  The manifest's section table
carries each section's byte length, CRC32, dtype and shape — so sections are
length-prefixed and checksummed exactly as a packed single-file format would
be, while keeping every array a plain ``.npy`` that ``np.load(mmap_mode="r")``
can map without copying (the serve-from-checkpoint cold start).  The manifest
itself is covered by a ``header_crc32`` over its canonical-JSON encoding.

All writes go through a ``faultfs`` io object so the fault-injection harness
can kill the writer at any byte offset.  Readers validate CRCs before any
byte reaches index state; validation failures raise ``CorruptError`` (a clean
refusal — never a silently corrupt index).

See ``PERSISTENCE.md`` for the full format specification.
"""
from __future__ import annotations

import io as _io
import json
import os
import zlib

import numpy as np

from .faultfs import OsIO

FORMAT_MAGIC = "WOWCKPT"
#: current writer version.  v2 added quantized vector sections
#: (``q_vectors``/``q_scales`` + ``vec_dtype`` meta) and switched the
#: ``dead_vals`` section to f32 (attrs are f32-canonical at ingest, so f32
#: is lossless; v1 checkpoints wrote f64 and are migrated on read).
FORMAT_VERSION = 2
#: versions this reader accepts.  Old checkpoints stay readable — version
#: bumps are for *new sections/semantics*, never a re-encode of old ones.
SUPPORTED_VERSIONS = (1, 2)
MANIFEST_NAME = "MANIFEST.json"


class CorruptError(Exception):
    """A checkpoint or WAL artifact failed validation (CRC/structure)."""


# ----------------------------------------------------------------- npy codec
def encode_npy(arr: np.ndarray) -> bytes:
    """Serialize an array to ``.npy`` bytes (format 1.0, no pickle)."""
    buf = _io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def decode_npy(data: bytes) -> np.ndarray:
    return np.load(_io.BytesIO(data), allow_pickle=False)


def canonical_json(obj) -> bytes:
    """Deterministic JSON encoding (sorted keys, no whitespace) — the byte
    string both the writer and the reader compute ``header_crc32`` over."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


# ------------------------------------------------------------ section writer
STREAM_CHUNK_BYTES = 256 << 10  # replication bootstrap streaming granularity


def chunk_crcs(data: bytes, chunk_bytes: int = STREAM_CHUNK_BYTES) -> list[int]:
    """Per-chunk CRC32 table over ``data`` split into ``chunk_bytes`` runs.
    Replica bootstrap streams sections chunk-at-a-time and, after a
    dropped transport or a crash, resumes by re-requesting only the
    chunks whose bytes on disk fail this table — never the full copy."""
    out = [crc32(data[off:off + chunk_bytes])
           for off in range(0, len(data), chunk_bytes)]
    return out or [crc32(b"")]


def write_section(io: OsIO, dirpath: str, name: str, arr: np.ndarray,
                  chunk_bytes: int = STREAM_CHUNK_BYTES) -> dict:
    """Write one array section as ``<name>.npy``; return its table entry."""
    data = encode_npy(arr)
    fname = f"{name}.npy"
    f = io.create(os.path.join(dirpath, fname))
    try:
        io.write(f, data)
        io.fsync(f)
    finally:
        io.close(f)
    return {
        "file": fname,
        "nbytes": len(data),
        "crc32": crc32(data),
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
        "chunk_bytes": chunk_bytes,
        "chunk_crcs": chunk_crcs(data, chunk_bytes),
    }


def read_section(dirpath: str, name: str, entry: dict,
                 mmap: bool = False) -> np.ndarray:
    """Read + validate one section.  With ``mmap=True`` the array is memory
    mapped (validation reads the file once through the page cache; the
    returned array then serves lazily from the mapping)."""
    path = os.path.join(dirpath, entry["file"])
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise CorruptError(f"section {name!r}: unreadable ({e})") from e
    if len(data) != entry["nbytes"]:
        raise CorruptError(
            f"section {name!r}: {len(data)} bytes on disk, manifest says "
            f"{entry['nbytes']}"
        )
    if crc32(data) != entry["crc32"]:
        raise CorruptError(f"section {name!r}: CRC32 mismatch")
    if mmap:
        arr = np.load(path, mmap_mode="r", allow_pickle=False)
    else:
        arr = decode_npy(data)
    if str(arr.dtype) != entry["dtype"] or list(arr.shape) != entry["shape"]:
        raise CorruptError(
            f"section {name!r}: dtype/shape {arr.dtype}/{arr.shape} does not "
            f"match manifest {entry['dtype']}/{entry['shape']}"
        )
    return arr


# ---------------------------------------------------------------- manifest
def write_manifest(io: OsIO, dirpath: str, manifest: dict) -> None:
    """Finalize the manifest: stamp magic/version, append ``header_crc32``
    over the canonical encoding, write + fsync."""
    manifest = dict(manifest)
    manifest["magic"] = FORMAT_MAGIC
    manifest["format_version"] = FORMAT_VERSION
    manifest.pop("header_crc32", None)
    manifest["header_crc32"] = crc32(canonical_json(manifest))
    f = io.create(os.path.join(dirpath, MANIFEST_NAME))
    try:
        io.write(f, json.dumps(manifest, sort_keys=True, indent=1).encode())
        io.fsync(f)
    finally:
        io.close(f)


def read_manifest(dirpath: str) -> dict:
    """Load + validate a checkpoint manifest (magic, version, header CRC)."""
    path = os.path.join(dirpath, MANIFEST_NAME)
    try:
        with open(path, "rb") as f:
            manifest = json.loads(f.read())
    except (OSError, ValueError) as e:
        raise CorruptError(f"manifest unreadable: {e}") from e
    if not isinstance(manifest, dict) or manifest.get("magic") != FORMAT_MAGIC:
        raise CorruptError("bad manifest magic")
    if manifest.get("format_version") not in SUPPORTED_VERSIONS:
        raise CorruptError(
            f"unsupported checkpoint format version "
            f"{manifest.get('format_version')!r} (reader supports "
            f"{SUPPORTED_VERSIONS})"
        )
    stated = manifest.get("header_crc32")
    body = {k: v for k, v in manifest.items() if k != "header_crc32"}
    if crc32(canonical_json(body)) != stated:
        raise CorruptError("manifest header CRC32 mismatch")
    return manifest
