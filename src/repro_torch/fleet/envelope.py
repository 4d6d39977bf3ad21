"""Shard envelopes: the checksummed unit of fleet ingest (ISSUE 6).

A producer packages one shard database directory (the output of
``aggregate()`` over its local measurement) into a single self-verifying
file, so delivery over any transport — spool directory, socket, object
store — is all-or-nothing: the daemon either reconstructs the exact
shard database the producer staged, or rejects the envelope to
quarantine.  Torn writes, truncated copies, and bit flips are all caught
by construction; they can never fold into the fleet database.

Wire format (little-endian)::

    magic   8 bytes   b"RFLEET1\\n"
    hlen    8 bytes   u64 header length
    header  hlen      JSON: shard_id, files [{name, size}...],
                      payload_size, payload_sha256, meta {...}
    payload ...       the files' bytes, concatenated in header order

The payload SHA-256 covers every file byte; ``payload_size`` makes
truncation detectable before hashing.  File names are relative paths
inside the database directory and are refused if they escape it
(``..`` / absolute), so a hostile envelope cannot write outside the
daemon's spool.

The default ``shard_id`` is content-addressed
(``<producer>-<sha256(payload)[:16]>``): a producer that re-packages and
re-sends the identical measurement after a crash lands on the same id,
and the daemon's journal dedups it — exactly-once ingest without
producer-side bookkeeping (``repro.fleet.journal``).

All writes are staged (temp file in the destination directory, flush,
``fsync``, rename), so a partially-written envelope is never visible
under its final name.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import struct
import tempfile
from typing import Dict, List, Optional, Tuple

from repro_torch.ft import inject

MAGIC = b"RFLEET1\n"
_HLEN = struct.Struct("<Q")

# fault points on the producer's staging path (client-side process)
FP_STAGE_PRE_WRITE = "client.stage.pre_write"
FP_STAGE_PRE_RENAME = "client.stage.pre_rename"
inject.register_points(FP_STAGE_PRE_WRITE, FP_STAGE_PRE_RENAME)


class EnvelopeError(ValueError):
    """A torn, truncated, corrupt, or malformed envelope."""


@dataclasses.dataclass(frozen=True)
class EnvelopeHeader:
    shard_id: str
    files: List[dict]               # [{"name": str, "size": int}, ...]
    payload_size: int
    payload_sha256: str
    meta: dict


def _iter_files(db_dir: str) -> List[str]:
    """Relative paths of every file under ``db_dir``, sorted — the
    canonical packing order, so identical databases pack to identical
    envelope bytes."""
    out = []
    for root, _dirs, files in os.walk(db_dir):
        for fn in files:
            out.append(os.path.relpath(os.path.join(root, fn), db_dir))
    return sorted(out)


def _check_relative(name: str) -> str:
    norm = os.path.normpath(name)
    if os.path.isabs(norm) or norm.startswith("..") or norm != name:
        raise EnvelopeError(f"envelope file name {name!r} escapes the "
                            "database directory")
    return norm


def atomic_write(dest: str, data: bytes) -> None:
    """Write-temp / flush / fsync / rename: ``dest`` is either absent or
    complete, never torn — the producer and transport commit primitive."""
    d = os.path.dirname(os.path.abspath(dest)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".tmp-envelope-", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        inject.fault_point(FP_STAGE_PRE_RENAME)
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def sweep_stale_temps(directory: str) -> int:
    """Remove ``.tmp-*`` droppings a crashed staging attempt left behind
    (they were never renamed, so they were never visible as envelopes)."""
    n = 0
    if not os.path.isdir(directory):
        return 0
    for fn in os.listdir(directory):
        if fn.startswith(".tmp-"):
            os.unlink(os.path.join(directory, fn))
            n += 1
    return n


def pack_envelope(db_dir: str, dest: str, *,
                  shard_id: Optional[str] = None,
                  producer: str = "producer",
                  meta: Optional[dict] = None) -> str:
    """Package ``db_dir`` into an envelope file at ``dest`` (staged
    atomically); returns the shard id.  ``dest`` may contain the
    placeholder ``{id}``, substituted with the (possibly
    content-derived) shard id."""
    inject.fault_point(FP_STAGE_PRE_WRITE)
    names = _iter_files(db_dir)
    if not os.path.exists(os.path.join(db_dir, "meta.json")):
        raise EnvelopeError(f"{db_dir}: not a database directory "
                            "(no meta.json)")
    blobs = []
    files = []
    h = hashlib.sha256()
    for name in names:
        with open(os.path.join(db_dir, name), "rb") as f:
            data = f.read()
        blobs.append(data)
        files.append({"name": name, "size": len(data)})
        h.update(data)
    payload_sha = h.hexdigest()
    if shard_id is None:
        shard_id = f"{producer}-{payload_sha[:16]}"
    header = {
        "shard_id": shard_id,
        "files": files,
        "payload_size": sum(len(b) for b in blobs),
        "payload_sha256": payload_sha,
        "meta": dict(meta or {}),
    }
    hdr = json.dumps(header, sort_keys=True).encode()
    out = dest.replace("{id}", shard_id)
    atomic_write(out, MAGIC + _HLEN.pack(len(hdr)) + hdr
                 + b"".join(blobs))
    return shard_id


def read_header(path: str) -> Tuple[EnvelopeHeader, int]:
    """Parse and validate the header; returns (header, payload offset).
    Raises ``EnvelopeError`` on anything short of a well-formed header."""
    try:
        with open(path, "rb") as f:
            magic = f.read(len(MAGIC))
            if magic != MAGIC:
                raise EnvelopeError(
                    f"{path}: bad magic {magic!r} (torn or not an "
                    "envelope)")
            raw = f.read(_HLEN.size)
            if len(raw) != _HLEN.size:
                raise EnvelopeError(f"{path}: truncated header length")
            (hlen,) = _HLEN.unpack(raw)
            if hlen > 64 * 1024 * 1024:
                raise EnvelopeError(f"{path}: implausible header length "
                                    f"{hlen}")
            hdr_raw = f.read(hlen)
            if len(hdr_raw) != hlen:
                raise EnvelopeError(f"{path}: truncated header")
    except OSError as e:
        raise EnvelopeError(f"{path}: unreadable ({e})") from e
    try:
        hdr = json.loads(hdr_raw.decode())
        header = EnvelopeHeader(
            shard_id=str(hdr["shard_id"]),
            files=[{"name": _check_relative(str(fe["name"])),
                    "size": int(fe["size"])} for fe in hdr["files"]],
            payload_size=int(hdr["payload_size"]),
            payload_sha256=str(hdr["payload_sha256"]),
            meta=dict(hdr.get("meta", {})))
    except EnvelopeError:
        raise
    except (ValueError, KeyError, TypeError) as e:
        raise EnvelopeError(f"{path}: malformed header ({e})") from e
    if header.payload_size != sum(fe["size"] for fe in header.files):
        raise EnvelopeError(f"{path}: header file sizes do not sum to "
                            "payload_size")
    return header, len(MAGIC) + _HLEN.size + hlen


def verify_envelope(path: str) -> EnvelopeHeader:
    """Full validation: header, payload length, SHA-256.  Raises
    ``EnvelopeError``; returns the header on success."""
    header, off = read_header(path)
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        f.seek(off)
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
            size += len(chunk)
    if size != header.payload_size:
        raise EnvelopeError(
            f"{path}: payload is {size} bytes, header says "
            f"{header.payload_size} (torn delivery)")
    if h.hexdigest() != header.payload_sha256:
        raise EnvelopeError(f"{path}: payload SHA-256 mismatch "
                            "(corrupt delivery)")
    return header


def unpack_envelope(path: str, dest_dir: str) -> EnvelopeHeader:
    """Verify and extract into ``dest_dir`` (staged: written to a
    sibling temp dir, committed by one rename — ``dest_dir`` is either
    absent or a complete shard database).  Idempotent: an existing
    ``dest_dir`` is left untouched."""
    header = verify_envelope(path)
    if os.path.isdir(dest_dir):
        return header            # already unpacked (crash replay)
    parent = os.path.dirname(os.path.abspath(dest_dir)) or "."
    os.makedirs(parent, exist_ok=True)
    work = tempfile.mkdtemp(prefix=".unpack_", dir=parent)
    try:
        with open(path, "rb") as f:
            _, off = read_header(path)
            f.seek(off)
            for fe in header.files:
                target = os.path.join(work, fe["name"])
                os.makedirs(os.path.dirname(target) or work, exist_ok=True)
                with open(target, "wb") as out:
                    out.write(f.read(fe["size"]))
        os.replace(work, dest_dir)
    except OSError:
        if os.path.isdir(dest_dir):   # lost a benign race to a replayer
            shutil.rmtree(work, ignore_errors=True)
            return header
        raise
    finally:
        if os.path.isdir(work):
            shutil.rmtree(work, ignore_errors=True)
    return header
