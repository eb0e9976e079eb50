"""Multi-host runner: two real processes over localhost decode disjoint
corpus stripes, gather stats with a cross-process collective, and the
combined WER equals the single-process golden numbers exactly.

This is the no-hardware validation of the jax.distributed path
(BASELINE.md's N≥2-host requirement): same code path a multi-host run uses,
with the coordinator/stripe/allgather machinery exercised for real.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from speechrecognition_tpu.parallel.multihost import (combine_rows,
                                                      host_shard)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_host_shard_partition():
    got = [host_shard(35, hosts=3, host=h) for h in range(3)]
    assert np.concatenate(got).tolist() == list(range(35))
    sizes = [len(g) for g in got]
    assert max(sizes) - min(sizes) <= 1


def test_combine_rows():
    rows = np.asarray([[3, 50, 2, 10, 30.0, 2.0],
                       [1, 47, 1, 9, 28.0, 2.5]])
    c = combine_rows(rows)
    assert abs(c["wer"] - 100.0 * 4 / 97) < 1e-9
    assert c["decode_seconds"] == 2.5          # hosts run concurrently
    assert abs(c["audio_s_per_s"] - 58.0 / 2.5) < 1e-9


def _run_two_workers(tmp_path, fixtures_dir, extra_args, timeout):
    port = socket.socket()
    port.bind(("localhost", 0))
    port_no = port.getsockname()[1]
    port.close()

    out = str(tmp_path / "multihost.json")
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "JAX_COMPILATION_CACHE_DIR": os.path.join(REPO, ".jax_cache"),
            "SPEECH_TPU_NUM_CPU_DEVICES": "2",
            "SPEECH_TPU_COORDINATOR": f"localhost:{port_no}",
            "SPEECH_TPU_NUM_PROCS": "2",
            "SPEECH_TPU_PROC_ID": str(pid),
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "speechrecognition_tpu.parallel.multihost",
             "--out", out, "--fixtures", str(fixtures_dir)] + extra_args,
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=timeout) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    with open(out) as f:
        return json.load(f)


def test_two_process_collectives_match_golden(tmp_path, fixtures_dir,
                                              demo_recognition):
    """Default-tier: two real processes over localhost initialize
    jax.distributed, stripe the golden hypotheses, and the allgathered
    corpus WER equals the single-process golden numbers exactly — the
    cross-process machinery can't rot unseen between slow-tier runs."""
    res = _run_two_workers(
        tmp_path, fixtures_dir,
        ["--golden-hyps", str(fixtures_dir / "demo_recognition.json")],
        timeout=420)
    assert res["distributed"] is True
    assert res["num_hosts"] == 2
    assert res["devices"] == 4 and res["local_devices"] == 2
    ref = demo_recognition["corpus"]
    assert abs(res["wer"] - ref["wer"]) < 1e-6
    assert abs(res["ser"] - ref["ser"]) < 1e-6


@pytest.mark.slow
def test_two_process_decode_matches_golden(tmp_path, fixtures_dir,
                                           demo_recognition):
    res = _run_two_workers(tmp_path, fixtures_dir, [], timeout=900)
    assert res["distributed"] is True
    assert res["num_hosts"] == 2
    assert res["devices"] == 4 and res["local_devices"] == 2
    ref = demo_recognition["corpus"]
    assert abs(res["wer"] - ref["wer"]) < 1e-3
    assert abs(res["ser"] - ref["ser"]) < 1e-3
