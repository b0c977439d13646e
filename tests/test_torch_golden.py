"""The golden ``.dcz`` fixtures (``tests/golden/``) through the port's two
services: the host codec (``CpuCompressionService``) and the GPU service on
the kernels' plain versions (``GpuCompressionService(device="cpu")``).

Each input in ``hashes.json`` compresses in java v1, with the fixed mtime of
``tests/test_golden.py``, to its pinned size and SHA-256 (and to its
checked-in archive, where there is one); the handmade container's content
compresses to that container.  Each checked-in ``.dcz``, the handmade one
included, decodes to its input and passes a deep verify.  The fixtures are
read, never written.  The same on the card, with K2 and K3, is in
``tests/test_torch_gpu.py``."""

import hashlib
import json
import os

import pytest

from datacomp_tpu_torch.config import load_config
from datacomp_tpu_torch.core import read_container
from datacomp_tpu_torch.ops import COUNTERS, TABLE_BITS, max_code_len, reset_counters
from datacomp_tpu_torch.services import CpuCompressionService, GpuCompressionService
from datacomp_tpu_torch.services.gpu_service import host_decode_routes
from datacomp_tpu_torch.utils.testdata import generate_bytes

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
FIXED_MTIME = 1_700_000_000  # tests/test_golden.py's
HANDMADE = "handmade_tie_v1.dcz"
HANDMADE_CONTENT = b"ABCDEFGH" * 4  # its source, handmade_tie.bin (tools/make_handmade_golden.py)

with open(os.path.join(GOLDEN_DIR, "hashes.json")) as _f:
    HASHES = json.load(_f)

SERVICES = {
    "cpu": lambda cfg: CpuCompressionService(cfg),
    "gpu-plain": lambda cfg: GpuCompressionService(cfg, device="cpu"),
}
ARCHIVES = sorted(n for n in os.listdir(GOLDEN_DIR) if n.endswith(".dcz"))


def _source(name: str) -> bytes:
    if name == "handmade_tie.bin":
        return HANDMADE_CONTENT
    spec = HASHES[name]
    return generate_bytes(spec["input_kind"], spec["input_size"])


def _fixture(name: str) -> bytes:
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("service", sorted(SERVICES))
@pytest.mark.parametrize("name", sorted(HASHES) + ["handmade_tie.bin"])
def test_compresses_to_the_pinned_bytes(tmp_path, service, name):
    src = tmp_path / name  # the header stores the basename
    src.write_bytes(_source(name))
    os.utime(src, (FIXED_MTIME, FIXED_MTIME))
    chunk_mb = HASHES[name]["chunk_mb"] if name in HASHES else 1
    cfg = load_config(compression={"chunk_size_mb": chunk_mb, "format_version": 1,
                                   "codebook_mode": "java"})
    out = str(src) + ".dcz"
    reset_counters()
    with SERVICES[service](cfg) as svc:
        svc.compress(str(src), out)
    blob = open(out, "rb").read()
    # the GPU service encoded every chunk through K2's plain version, a
    # group of one a call (batch 1 on the CPU)
    chunks = len(read_container(out)[0].chunks)
    assert COUNTERS["encode_batch"][1].value == (chunks if service == "gpu-plain" else 0)
    if name in HASHES:
        assert len(blob) == HASHES[name]["dcz_size"]
        assert hashlib.sha256(blob).hexdigest() == HASHES[name]["dcz_sha256"]
    archive = HANDMADE if name == "handmade_tie.bin" else name + ".dcz"
    if archive in ARCHIVES:
        assert blob == _fixture(archive)


@pytest.mark.parametrize("service", sorted(SERVICES))
@pytest.mark.parametrize("archive", ARCHIVES)
def test_decodes_and_deep_verifies(tmp_path, service, archive):
    path = os.path.join(GOLDEN_DIR, archive)
    want = HANDMADE_CONTENT if archive == HANDMADE else _source(archive.removesuffix(".dcz"))
    before = _fixture(archive)
    out = tmp_path / "restored.bin"
    host_decode_routes.reset()
    reset_counters()
    with SERVICES[service](load_config(compression={"chunk_size_mb": 1})) as svc:
        assert svc.verify_integrity(path, deep=True)
        svc.decompress(path, str(out))
    assert out.read_bytes() == want
    # v1 archives, decoded twice by the GPU service: a chunk whose codes are
    # at most 16 bits deep through the gap finder and K3, a deeper one
    # through the host route
    header, _ = read_container(path)
    assert header.version == 1
    depths = [max_code_len(c.code_lengths) for c in header.chunks]
    shallow = sum(1 for dep in depths if 0 < dep <= TABLE_BITS)
    gpu = service == "gpu-plain"
    assert host_decode_routes.value == (2 * (len(depths) - shallow) if gpu else 0)
    assert COUNTERS["find_gaps"][1].value == (2 * shallow if gpu else 0)
    assert COUNTERS["decode_batch"][1].value == (2 * shallow if gpu else 0)
    assert _fixture(archive) == before  # read, never written
