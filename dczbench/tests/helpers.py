"""Cells of BENCHMARK.json cut to a size the CPU serves in seconds."""

import json

from dczbench import run


def small_cell(workload: str, files: int = 3, scale: int = 40, chunk_mb: int = 1):
    """A cell of BENCHMARK.json cut to a size the CPU's plain kernels serve in
    seconds: 1 MiB chunks, batches of 4 as on the card, one round of the
    traffic's first ``files`` files at 1/``scale`` of their size."""
    bench, cell, config_doc, traffic = run.load_cell(workload)
    config_doc = json.loads(json.dumps(config_doc))
    config_doc["compression"]["chunk_size_mb"] = chunk_mb
    config_doc["device"] = {"batch_chunks": 4}
    traffic = dict(traffic, pool_bytes=65536, rounds=1,
                   files=[dict(f, bytes=max(9000, int(f["bytes"]) // scale))
                          for f in traffic["files"][:files]])
    return bench, cell, config_doc, traffic


def cpu_run(workload: str, seed: int = 2**31 + 77, control: bool = False, **cut):
    bench, cell, config_doc, traffic = small_cell(workload, **cut)
    return run.run_cell(workload, bench, config_doc, traffic, seed, 600.0, trace=False,
                        device="cpu", control=control)
