"""The port's multi-process data parallelism: two processes on ``gloo``.

Counterpart of ``tests/test_multiprocess.py`` (whose worker is
``tests/mp_worker.py``): a genuine two-process ``torch.distributed`` group
on localhost, brought up by ``initialize_distributed``, and an 8-entry
mesh of which each process owns four entries (the host's CPU, repeated).
Each process shards the same global batch, holds only its own rows, runs
the mel-dB step data-parallel over them and checks every block against a
``compute_batch`` of the whole batch computed in the process alone (rtol
1e-5, atol 1e-4, the JAX worker's). The two processes' rows must be
disjoint and together the batch.

The worker body is this file run as a script:
``python tests/test_torch_port_multiprocess.py <rank> <n> <port> <out.json>``.
"""

import json
import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_data_parallel(tmp_path):
    port = _free_port()
    outs = [tmp_path / f"p{i}.json" for i in range(2)]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = os.environ.copy()
    prev = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = repo + (os.pathsep + prev if prev else "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(i), "2", str(port), str(outs[i])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process worker timed out")
        logs.append(stdout.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i]}"

    results = [json.loads(o.read_text()) for o in outs]
    assert all(r["ok"] for r in results)
    assert all(r["process_count"] == 2 for r in results)
    assert all(r["global_devices"] == 8 and r["local_entries"] == 4 for r in results)
    assert all(r["collectives"] == 0 for r in results)
    batch = results[0]["batch"]
    rows0, rows1 = set(results[0]["rows"]), set(results[1]["rows"])
    assert rows0.isdisjoint(rows1)
    assert rows0 | rows1 == set(range(batch))


def _worker(pid: int, nproc: int, port: str, out_path: str) -> int:
    import numpy as np
    import torch.distributed as dist

    import spectrograms_tpu_torch as tg
    from spectrograms_tpu_torch.parallel import (create_device_mesh, data_parallel_pipeline,
                                                 initialize_distributed, shard_batch)

    initialize_distributed(f"localhost:{port}", nproc, pid)
    assert dist.get_world_size() == nproc and dist.get_rank() == pid
    assert dist.get_backend() == "gloo"

    plan = tg.SpectrogramPlan(
        tg.SpectrogramParams(tg.StftParams(256, 128), 16000.0),
        tg.FreqScale.MEL, tg.AmpScale.DECIBELS,
        scale_params=tg.MelParams(32, 0.0, 8000.0, tg.MelNorm.SLANEY),
        dtype="float32", device="cpu",
    )
    n_entries = 4 * nproc
    mesh = create_device_mesh((n_entries,), ("data",), devices=["cpu"] * n_entries)
    local_entries = int((mesh.process_ids == pid).sum())
    step = data_parallel_pipeline(plan._forward_impl, mesh)

    batch = n_entries * 2
    xg = np.random.default_rng(0).standard_normal((batch, 8192)).astype(np.float32)
    calls = []
    for name in ("all_reduce", "all_gather", "broadcast", "send", "recv", "barrier"):
        real = getattr(dist, name)
        setattr(dist, name, lambda *a, _r=real, _n=name, **k: (calls.append(_n), _r(*a, **k))[1])
    out = step(shard_batch(xg, mesh))
    n_calls = len(calls)

    # the whole batch in this process alone: every block held must match
    ref = plan.compute_batch(xg).numpy()
    rows, ok = [], True
    for shard in out.addressable_shards:
        got = shard.data.numpy()
        if not np.allclose(got, ref[shard.index], rtol=1e-5, atol=1e-4):
            ok = False
        rows.extend(range(*shard.index.indices(batch)))
    dist.barrier()
    with open(out_path, "w") as f:
        json.dump({"pid": pid, "ok": bool(ok), "rows": sorted(rows),
                   "process_count": dist.get_world_size(), "global_devices": mesh.size,
                   "local_entries": local_entries, "collectives": n_calls, "batch": batch}, f)
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]))
