"""The port's serve entry point (python -m repro_torch.launch.serve):

* --backend exec --device cpu --verify reports every step within 1e-6 of
  the single-instance oracle;
* --backend analytic prints the same lines as repro.launch.serve on the
  same arguments, and a trace saved by either package replays in the other;
* it runs on the card unless told otherwise, and refuses to carry on
  without one.
"""

import re

import pytest
import torch

from repro.launch import serve as jax_serve
from repro_torch.launch import serve

SMALL = ["--instances", "4", "--pods", "2", "--chunks", "6",
         "--chunk-tokens", "64", "--agents", "6", "--steps", "3",
         "--selection-frac", "0"]


def _errors(out: str):
    return [float(x) for x in re.findall(r"max\|err\| (\S+)", out)]


def test_exec_cpu_verify_within_oracle(capsys):
    serve.main(SMALL + ["--backend", "exec", "--device", "cpu", "--verify"])
    errs = _errors(capsys.readouterr().out)
    assert len(errs) == 3 and max(errs) <= 1e-6


def test_exec_cpu_v2_lite_geometry(capsys):
    eng = serve.main(SMALL + ["--backend", "exec", "--device", "cpu",
                              "--exec-geometry", "v2-lite", "--verify",
                              "--steps", "2", "--chunk-tokens", "32"])
    errs = _errors(capsys.readouterr().out)
    # d_qk = 576: the reference kernels' tolerance at that width
    assert len(errs) == 2 and max(errs) <= 5e-6
    out = next(iter(eng.outputs_of(1).values()))
    assert out.o.shape[1:] == (16, 512)


@pytest.mark.parametrize("extra", [[], ["--pipeline-depth", "2"],
                                   ["--steps", "5", "--agents", "12"]])
def test_analytic_output_matches_reference(capsys, extra):
    jax_serve.main(SMALL + extra)
    want = capsys.readouterr().out
    serve.main(SMALL + extra)
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert "[serve] step 1:" in got


def test_trace_replays_across_packages(tmp_path, capsys):
    path = str(tmp_path / "t.json")
    jax_serve.main(SMALL + ["--save-trace", path])
    want = capsys.readouterr().out
    serve.main(["--trace", path, "--selection-frac", "0"])
    got = capsys.readouterr().out
    strip = [ln for ln in got.splitlines() if "meta overrides" not in ln]
    assert strip == want.splitlines()
    serve.main(["--trace", path, "--backend", "exec", "--device", "cpu",
                "--verify", "--selection-frac", "0"])
    assert max(_errors(capsys.readouterr().out)) <= 1e-6


def test_flag_checks():
    with pytest.raises(SystemExit, match="requires --backend exec"):
        serve.main(["--verify"])
    with pytest.raises(SystemExit):
        serve.main(["--trace", "a.json", "--save-trace", "b.json"])
    args = serve.build_parser().parse_args([])
    assert (args.device, args.exec_geometry, args.backend) \
        == ("cuda", "tiny", "analytic")


def test_exec_defaults_to_the_card_and_refuses_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal needs its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(SMALL + ["--backend", "exec"])
