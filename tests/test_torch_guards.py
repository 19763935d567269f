"""The port's runtime guards (``repro_torch.common.guards``).

The port of the guard tests of ``tests/test_staticcheck.py``
(``TestGuards``): ``CompileGuard`` watching an object, churn raising, the
process-wide counter (the port's compile events are kernel builds, library
loads and recorded graph captures) and measure-only; ``strict_numerics``
rejecting mixed floating dtypes, allowing Python scalars and explicit
conversions, and catching NaNs under ``debug_nans``; ``no_host_sync``
allowing the explicit fetch.  The card itself (``no_host_sync`` raising on
an implicit sync) is ``chip_smoke.py``'s phase G4; here the guard's mode
handling is checked against a recording stand-in for the card's sync
debug mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.common import (CompileGuard, device_get,  # noqa: E402
                                global_compile_count, guards, no_host_sync,
                                record_compile, strict_numerics)


class _Counted:
    calls = 0

    def compile_count(self):
        return self.calls


def test_compile_guard_passes_steady_state():
    obj = _Counted()
    with CompileGuard(obj) as g:
        pass
    assert g.retraces() == 0


def test_compile_guard_raises_on_churn():
    obj = _Counted()
    with pytest.raises(AssertionError, match="churning the jit cache"):
        with CompileGuard(obj, label="shape churn"):
            obj.calls += 2


def test_compile_guard_watched_object_within_its_limit():
    obj = _Counted()
    with CompileGuard(obj, max_retraces=1) as g:
        obj.calls += 1
    assert g.retraces() == 1


def test_compile_guard_refuses_a_target_it_cannot_count():
    with pytest.raises(TypeError, match="compile_count"):
        CompileGuard(object())


def test_compile_guard_global_counter_and_measure_only():
    with CompileGuard() as g:   # no watch targets: process-wide
        pass
    assert g.retraces() == 0
    with pytest.raises(AssertionError, match="compiled 1 time"):
        with CompileGuard(label="a capture"):
            record_compile()
    with CompileGuard(max_retraces=None) as g:
        for _ in range(3):
            record_compile()
    assert g.retraces() == 3


def test_kernel_builds_and_loads_are_compile_events(monkeypatch):
    """``_build.load`` counts one event per library it loads (and
    ``build_all`` one per ``nvcc`` it starts); a loaded library counts
    nothing more."""
    from repro_torch.kernels import _build
    built = []
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build_all",
                        lambda names=None: built.extend(names) or {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    before = global_compile_count()
    with CompileGuard(max_retraces=None) as g:
        lib = _build.load("paged_decode")
    assert g.retraces() == 1 and built == ["paged_decode"]
    with CompileGuard() as g:
        assert _build.load("paged_decode") is lib
    assert global_compile_count() == before + 1


def test_strict_numerics_rejects_mixed_floating_dtypes():
    with strict_numerics():
        torch.ones(3) + 1.0                      # weak Python scalar: fine
        torch.ones(3, dtype=torch.bfloat16) * 2  # likewise
        torch.ones(3) + torch.ones(3, dtype=torch.int32)   # one float dtype
        torch.ones(3).to(torch.float64) + torch.ones(3, dtype=torch.float64)
        with pytest.raises(guards.PromotionError, match="mixes"):
            torch.ones(3) + torch.ones(3, dtype=torch.float64)
        with pytest.raises(guards.PromotionError, match="mixes"):
            torch.where(torch.ones(3) > 0, torch.ones(3),
                        torch.ones(3, dtype=torch.bfloat16))
        with pytest.raises(guards.PromotionError, match="mixes"):
            torch.cat([torch.ones(2), torch.ones(2, dtype=torch.float16)])
    torch.ones(3) + torch.ones(3, dtype=torch.float64)   # off again


def test_strict_numerics_debug_nans():
    nan = torch.tensor([0.0, float("nan")])
    with strict_numerics():
        torch.zeros(2) / torch.zeros(2)          # NaNs allowed without it
    with strict_numerics(debug_nans=True):
        torch.ones(2) * 2.0
        with pytest.raises(FloatingPointError, match="NaN"):
            torch.zeros(2) / torch.zeros(2)
        with pytest.raises(FloatingPointError, match="NaN"):
            nan + 1.0


def test_no_host_sync_allows_explicit_fetch():
    reads = guards.host_reads
    with no_host_sync():
        out = device_get(torch.arange(3.0))
        pair = device_get((torch.tensor(True), torch.tensor([1, 2])))
    assert np.allclose(out, [0.0, 1.0, 2.0]) and isinstance(out, np.ndarray)
    assert bool(pair[0]) and pair[1].tolist() == [1, 2]
    assert guards.host_reads == reads + 2


def test_no_host_sync_sets_and_restores_the_sync_debug_mode(monkeypatch):
    """On a card: "error" inside the region, the previous mode after it,
    and ``device_get`` lowers the mode around its own copy only."""
    mode = [0]
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])

    def set_mode(m):
        mode[0] = {"default": 0, "warn": 1, "error": 2}.get(m, m)
        seen.append(mode[0])

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    mode[0] = 1                                  # a caller's "warn"
    with no_host_sync():
        assert mode[0] == 2
        device_get(torch.ones(2))
        assert mode[0] == 2
    assert mode[0] == 1
    assert seen == [2, 0, 2, 1]
    with pytest.raises(ValueError):
        with no_host_sync():
            raise ValueError("the region failed")
    assert mode[0] == 1


def test_solver_host_reads_go_through_the_explicit_fetch():
    """The repair/polish loops read their ``done`` flag through
    ``device_get`` (allowed under ``no_host_sync``), once per chunk."""
    from repro_torch.core import optimizer as opt
    rng = np.random.RandomState(0)
    n, m = 64, 4
    cost = torch.from_numpy(rng.rand(n, m).astype(np.float32))
    qual = torch.from_numpy(rng.rand(n, m).astype(np.float32))
    loads = torch.full((m,), 16.0)
    x0 = torch.zeros(n, dtype=torch.long)        # all on model 0: overloaded
    fetch0 = guards.host_reads
    stats = {}
    with no_host_sync():
        x = opt.repair_workload(x0, cost, qual, loads, chunk=8, stats=stats)
    assert np.all(np.bincount(x.numpy(), minlength=m) <= 16)
    # one read a chunk of 8 moves (the flag ends the loop a chunk after the
    # last move at most) and one of the move count (``_record``)
    moves = stats["repair_moves"]
    assert moves > 0
    assert -(-moves // 8) + 1 <= guards.host_reads - fetch0 <= moves // 8 + 2


@pytest.mark.parametrize("value", [0.75, 3, np.float64(2.5), np.float32(0.1),
                                   np.array(1.25), [1.0, 2.5],
                                   np.arange(4, dtype=np.float64),
                                   torch.arange(3, dtype=torch.float64)])
def test_f32_matches_as_tensor(value):
    """The solver's float32 conversion (filled on the device for scalars,
    a pinned copy for arrays on the card) gives ``torch.as_tensor``'s
    values and shape."""
    from repro_torch.core.optimizer import _f32
    got = _f32(value, "cpu")
    want = torch.as_tensor(value, dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
