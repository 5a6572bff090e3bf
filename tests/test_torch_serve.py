"""Smoke the port's serving launcher (`repro_torch.launch.serve`) on the CPU:
the twins of tests/test_launch_serve.py."""

import pytest

pytest.importorskip("torch")

from repro_torch.launch.serve import main  # noqa: E402
from repro_torch.serve import metrics as m  # noqa: E402


def test_serve_smoke_emits_shared_metric_names(capsys):
    out = main(["--arch", "h2o-danube-1.8b", "--smoke", "--device", "cpu", "--batch", "1",
                "--prompt-len", "4", "--gen", "2"])
    assert out["finite"]
    assert out["generated_shape"] == [1, 2]
    assert out[m.TTFT_S] > 0
    assert out[m.TPOT_S] > 0
    assert out[m.TTFT_S] == pytest.approx(out["prefill_s"], abs=1e-3)
    assert out["device"] == "cpu"
    assert capsys.readouterr().out.strip()  # JSON went to stdout


def test_serve_rejects_zero_generation():
    with pytest.raises(SystemExit, match="--gen"):
        main(["--arch", "h2o-danube-1.8b", "--smoke", "--device", "cpu", "--gen", "0"])


def test_serve_metric_names_match_the_jax_vocabulary():
    from repro.serve import metrics as jm
    names = [n for n in dir(jm) if n.isupper()]
    assert {n: getattr(m, n) for n in names} == {n: getattr(jm, n) for n in names}
