"""A run with its timed path broken underneath comes out not correct: the
rest of a run (set-up, window, check) on the CPU, past the look for a card.
One cell on one device has no exchange between chips to leave out."""

import time

import pytest
import torch

import sphtpu_torch.engine as engine
from benchmark import harness


def broken(fault):
    """make_chunk_runner whose chunks return `fault`'s wrong answer."""
    real = engine.make_chunk_runner

    def make(cfg, **kw):
        runner = real(cfg, **kw)

        def chunk(state, params, h0, n_steps, mlargs=None, **more):
            new, stats, valid, h, rho, nfb = runner(state, params, h0, n_steps, mlargs, **more)
            if fault == "unchanged":  # a step that returns its state unchanged
                new = state
            elif fault == "half":  # half of the particles left out of the update
                half = state.pos.shape[0] // 2
                new = type(new)(*(torch.cat([a[:half], b[half:]]) for a, b in
                                  zip(new[:3], state[:3])), new.t)
            elif fault == "h":  # one answer altered where it is produced
                h = h.clone()
                h[h.shape[0] // 3] *= 1.01
            elif fault == "entropy":
                K = new.K.clone()
                K[0] *= 1.01
                new = new._replace(K=K)
            elif fault == "stats":
                stats = stats.clone()
                stats[0, 2] *= 1.01
            return new, stats, valid, h, rho, nfb

        return chunk

    return make


def run(root, cell):
    return harness.execute(root, cell, 29, 0.01, False, device="cpu",
                           t_start=time.perf_counter())


@pytest.mark.parametrize("cell", ["tiny.tiles", "tiny.blocks"])
def test_a_sound_run_is_correct(small_root, cell):
    r = run(small_root, cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("fault", ["unchanged", "half", "h", "entropy", "stats"])
def test_a_broken_chunk_is_not_correct(small_root, monkeypatch, fault):
    monkeypatch.setattr(engine, "make_chunk_runner", broken(fault))
    r = run(small_root, "tiny.tiles")
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def not_finite_at(calls):
    """make_chunk_runner whose chunks return a position that is not finite
    on the given calls (counted over the run: the warm-up is call 1)."""
    real = engine.make_chunk_runner
    count = [0]

    def make(cfg, **kw):
        runner = real(cfg, **kw)

        def chunk(state, params, h0, n_steps, mlargs=None, **more):
            new, stats, valid, h, rho, nfb = runner(state, params, h0, n_steps, mlargs, **more)
            count[0] += 1
            if count[0] in calls:
                pos = new.pos.clone()
                pos[pos.shape[0] // 2, 0] = float("nan")
                new = new._replace(pos=pos)
            return new, stats, valid, h, rho, nfb

        return chunk

    return make


def test_a_failed_request_makes_the_run_not_correct(small_root, monkeypatch):
    """One request in two of the window returns a state that is not finite,
    while the sample that is compared holds only sound requests."""
    monkeypatch.setattr(engine, "make_chunk_runner", not_finite_at(set(range(3, 200, 2))))
    # a window of several requests (a tiny request takes about a second,
    # several on a loaded CPU): at least one sound, at least one failed
    r = harness.execute(small_root, "tiny.tiles", 29, 8.0, False, device="cpu",
                        t_start=time.perf_counter())
    assert r["attempted"] >= 2 and r["failed"] >= 1, (r["attempted"], r["failed"])
    assert not r["correct"]
    assert r["checks"]["failed_requests"] == {"value": r["failed"], "limit": 0}
    assert all(c["value"] <= c["limit"] for k, c in r["checks"].items() if k != "failed_requests")


def test_a_failed_traced_request_makes_the_run_not_correct(small_root, monkeypatch):
    # warm-up (call 1) and the window's one request (call 2) are sound
    monkeypatch.setattr(engine, "make_chunk_runner", not_finite_at({3}))
    r = harness.execute(small_root, "tiny.tiles", 29, 0.01, True, device="cpu",
                        t_start=time.perf_counter())
    assert r["attempted"] == 1 and r["failed"] == 0
    assert not r["correct"] and r["checks"]["failed_requests"]["value"] == 1
