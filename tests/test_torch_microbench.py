"""tools/microbench.py runs every stage (the plain versions on the CPU, at
a 32x32 camera with 100 of 256 surfels) and reports a time for each."""
import numpy as np
import torch


def test_microbench_runs_every_stage(monkeypatch, capsys):
    from gaus_slam_tpu_torch.tools import microbench

    for k, v in dict(MB_H="32", MB_W="32", MB_N="100", MB_CAP="256",
                     MB_REPS="1").items():
        monkeypatch.setenv(k, v)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ms = microbench.main(["--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    assert set(ms) == set(microbench.STAGES)
    assert all(np.isfinite(v) and v > 0 for v in ms.values()), ms
    out = capsys.readouterr().out
    assert "device=cpu (host time)" in out and "overflow=False" in out
    # a subset of stages
    assert set(microbench.main(["--device", "cpu", "pre", "bin"])) == {
        "pre", "bin"}
