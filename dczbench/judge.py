"""The comparison that decides ``correct``.

During the window, :func:`capture` reads each request's outputs back (outside
the request's timed calls) and keeps what the judge needs: the container's
parsed footer, each payload's digest and the restored file's digest.  After
the window, :func:`judge` holds every captured request against the plain
reference's :func:`~dczbench.reference.expected_file` of its input, and counts
the faults of each kind; :func:`verify_faults` holds the restore to the
configuration's guarantee that every chunk's SHA-256 is checked.  Every
comparison is exact, so each limit is 0.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from .reference import parse_container

#: the numbers compared, in the order printed; each limit is 0
CHECKS = ("failed_requests", "container_faults", "sha_faults", "codebook_faults",
          "raw_store_faults", "payload_faults", "gap_faults", "restore_faults",
          "verify_faults")


def _file_sha256(path: str) -> tuple:
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 22)
            if not block:
                break
            size += len(block)
            h.update(block)
    return size, h.digest()


def capture(dcz_path: str, restored_path: str | None) -> dict:
    """What the judge needs of one request's outputs.  A container that does
    not parse is kept as its error."""
    with open(dcz_path, "rb") as f:
        buf = f.read()
    try:
        parsed = parse_container(buf)
    except (ValueError, UnicodeDecodeError) as e:
        parsed = {"error": str(e)}
    out = {"container": parsed, "dcz_bytes": len(buf)}
    if restored_path is not None and os.path.exists(restored_path):
        out["restored"] = _file_sha256(restored_path)
    return out


def _header_faults(got: dict, want: dict, name: str, mtime_ms: int, version: int) -> int:
    faults = 0
    faults += got["version"] != version
    faults += got["name"] != name
    faults += got["size"] != want["size"]
    faults += got["mtime_ms"] != mtime_ms
    faults += got["chunk_bytes"] != want["chunk_bytes"]
    faults += got["subblock"] != want["subblock"]
    faults += got["count"] != len(want["chunks"])
    faults += got["footer_end"] != got["file_bytes"] - 8
    at = 0
    for i, c in enumerate(got["chunks"]):
        faults += c["index"] != i
        faults += c["orig_offset"] != i * want["chunk_bytes"]
        faults += c["comp_offset"] != at
        faults += not c["inside"]
        at += c["size"]
    faults += got["footer_at"] != at
    return int(faults)


def judge_request(got: dict | None, want: dict, name: str, mtime_ms: int,
                  version: int) -> dict:
    """Fault counts of one request against its input's expected container
    (``got`` None: the compress failed; ``got["failed"]``: the restore did)."""
    faults = dict.fromkeys(CHECKS, 0)
    if got is None or "error" in got.get("container", {}):
        faults["failed_requests" if got is None else "container_faults"] += 1
        return faults
    faults["failed_requests"] += bool(got.get("failed"))
    c = got["container"]
    faults["container_faults"] += _header_faults(c, want, name, mtime_ms, version)
    faults["sha_faults"] += c["global_sha256"] != want["global_sha256"]
    for g, w in zip(c["chunks"], want["chunks"]):
        faults["sha_faults"] += g["sha256"] != w["sha256"]
        got_raw = not g["lengths"].any() and g["size"] == g["orig_size"]
        faults["raw_store_faults"] += got_raw != w["raw"]
        faults["codebook_faults"] += not np.array_equal(g["lengths"], w["lengths"])
        faults["payload_faults"] += (g["size"] != w["size"]
                                     or g["payload_sha256"] != w["payload_sha256"])
        faults["gap_faults"] += not np.array_equal(g["gaps"], w["gaps"])
    faults["payload_faults"] += abs(len(c["chunks"]) - len(want["chunks"]))
    restored = got.get("restored")
    faults["restore_faults"] += restored != (want["size"], want["input_sha256"])
    return faults


def judge(requests: list, expected: list, names: list, mtimes: list, version: int) -> dict:
    """Summed fault counts over ``requests``: (file index, capture or None)."""
    total = dict.fromkeys(CHECKS, 0)
    for index, got in requests:
        for k, v in judge_request(got, expected[index], names[index], mtimes[index],
                                  version).items():
            total[k] += v
    return total


def verify_faults(restore, dcz_path: str, out_path: str, rng) -> int:
    """1 unless ``restore`` refuses the served ``.dcz`` at ``dcz_path`` once
    one bit of one chunk's stored SHA-256 (drawn from ``rng``) is flipped.
    Its payloads still decode to the chunk's bytes, so only the check of
    the digest on restore can find the change.  A missing or unparsable
    file counts too: the guarantee was not shown."""
    try:
        with open(dcz_path, "rb") as f:
            buf = f.read()
        chunks = parse_container(buf)["chunks"]
    except (OSError, ValueError):
        return 1
    if not chunks:
        return 1
    at = chunks[int(rng.integers(len(chunks)))]["sha_at"]
    with open(dcz_path, "r+b") as f:
        f.seek(at)
        f.write(bytes([buf[at] ^ 1]))
    try:
        restore(dcz_path, out_path)
    except Exception:  # noqa: BLE001 - any refusal shows the check; nothing else differs
        return 0
    return 1
