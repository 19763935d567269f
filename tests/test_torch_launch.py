"""The port's serving launcher (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``) on the CPU.

With ``--requests 8 --max-new 2`` both print the same served count, SR, $,
windows and, per endpoint, the same requests, tokens, decode chunks and
batch re-prefills: everything but the wall time, the route seconds and the
reference's XLA compiles (no eager counterpart).  The routing and the
counts do not depend on the weights, since no request stops early.  The
``--stream`` form on the port alone serves every request over more than
one window with dual iterations.
"""
import re

import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as jax_serve  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ARGS = ["--requests", "8", "--max-new", "2"]


def _normalize(text):
    """The printed lines without wall time, route seconds and compiles."""
    text = re.sub(r" in [0-9.]+s \(", " in _s (", text)
    text = re.sub(r"route overhead [0-9.]+s", "route overhead _s", text)
    text = re.sub(r", \d+ compiles", "", text)
    return [line.rstrip() for line in text.splitlines() if line.strip()]


def test_serve_main_prints_what_the_reference_prints(capsys):
    jax_serve.main(ARGS)
    want = _normalize(capsys.readouterr().out)
    got = serve.main(ARGS + ["--device", "cpu"])
    printed = _normalize(capsys.readouterr().out)
    assert printed == want
    assert len(want) == 7 and want[0].startswith("served 8/8 requests")
    assert got["served"] == got["n"] == 8 and got["rids"] == list(range(8))
    assert [e["reqs"] for e in got["endpoints"]] == [
        got["endpoint"].count(j) for j in range(6)]
    assert all(e["reprefills"] == 0 for e in got["endpoints"])


def test_serve_stream_serves_every_request_over_windows(capsys):
    got = serve.main(ARGS + ["--arrival", "poisson", "--arrival-rate", "4",
                             "--stream", "--device", "cpu"])
    out = capsys.readouterr().out
    assert got["served"] == 8 and got["rids"] == list(range(8))
    assert got["windows"] > 1 and got["dual_iters"] > 0
    assert "streaming dual" in out and f"{got['dual_iters']} dual iters" in out


def test_serve_refuses_an_unknown_full_member():
    with pytest.raises(SystemExit):
        serve.main(ARGS + ["--full", "llama-7b", "--device", "cpu"])
