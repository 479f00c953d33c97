"""The port's learned tracker (learned_tracking.py) against the JAX package,
f32 on the CPU.

Tolerances: the host features are the same numpy code and are held to the
bit; the scorer's logits within 1e-5 of max|ref| (f32 in both, the matmuls
in another order); the links, tracks, parent graphs, regime signals and
choices that follow from them are held to the bit; ``train_linker`` against
optax's Adam over 50 steps from the same initial weights within 1e-4 of
max|ref| per parameter.
"""
import numpy as np
import pytest
import torch

from tests.torch_port_util import one_thread, rel_err


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


PARAM_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3", "mu", "sigma")


@pytest.fixture(scope="module")
def packaged():
    from micro_sam_tpu_torch.learned_tracking import _PACKAGED_WEIGHTS, load_linker
    return load_linker(_PACKAGED_WEIGHTS)


def _trackers(params, **kw):
    from micro_sam_tpu.learned_tracking import LearnedTracker as JaxTracker
    from micro_sam_tpu_torch.learned_tracking import LearnedTracker
    return LearnedTracker(params, device="cpu", **kw), JaxTracker(params, **kw)


def _sequence(kind, seed=0, **kw):
    from micro_sam_tpu_torch import learned_tracking as lt
    if kind == "hela":
        return lt.hela_like_tracking_sequence(n_frames=8, seed=seed, **kw)
    return lt.synthetic_tracking_sequence(n_frames=8, n_objects=6, division_prob=0.2,
                                          seed=seed, **kw)


def test_packaged_weights_are_the_jax_packages():
    import os
    from micro_sam_tpu.learned_tracking import _PACKAGED_WEIGHTS as JAX_WEIGHTS
    from micro_sam_tpu_torch.learned_tracking import _PACKAGED_WEIGHTS
    assert os.path.exists(_PACKAGED_WEIGHTS) and "micro_sam_tpu_torch" in _PACKAGED_WEIGHTS
    with open(_PACKAGED_WEIGHTS, "rb") as a, open(JAX_WEIGHTS, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("kind,seed", [("hela", 0), ("hela", 3), ("synthetic", 1)])
def test_features_match_jax(kind, seed):
    from micro_sam_tpu import learned_tracking as jlt
    from micro_sam_tpu_torch import learned_tracking as lt
    images, segs, _ = _sequence(kind, seed)
    for t in (0, 4):
        got = lt.extract_frame_features(segs[t], images[t])
        ref = jlt.extract_frame_features(segs[t], images[t])
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2]
    f0, f1 = lt.extract_frame_features(segs[0]), lt.extract_frame_features(segs[1])
    got = lt.pair_features(f0[1], f1[1], f0[2], f1[2])
    np.testing.assert_array_equal(got, jlt.pair_features(f0[1], f1[1], f0[2], f1[2]))
    assert got.shape == (len(f0[0]), len(f1[0]), lt.PAIR_DIM) and got.dtype == np.float32


def test_scorer_matches_linker_apply(packaged):
    """The packaged weights through LinkScorer against the JAX package's
    linker_apply: logits within rel 1e-5."""
    from micro_sam_tpu import learned_tracking as jlt
    from micro_sam_tpu_torch import learned_tracking as lt
    images, segs, _ = _sequence("hela", 1)
    a, b = lt.extract_frame_features(segs[2], images[2]), lt.extract_frame_features(segs[3],
                                                                                   images[3])
    pf = lt.pair_features(a[1], b[1], a[2], b[2])
    scorer = lt.scorer_from_params(packaged)
    with torch.no_grad():
        got = scorer(torch.from_numpy(pf)).numpy()
    ref = np.asarray(jlt.linker_apply(packaged, pf))
    assert got.shape == ref.shape == pf.shape[:2] and got.dtype == np.float32
    assert rel_err(got, ref) <= 1e-5
    assert rel_err(lt.linker_apply(packaged, pf), ref) <= 1e-5
    assert rel_err(lt.linker_apply(scorer, pf), ref) <= 1e-5


def test_scorer_state_round_trip(packaged):
    from micro_sam_tpu_torch import learned_tracking as lt
    state = lt.scorer_state_from_params(packaged)
    assert state["fc1.weight"].shape == (64, lt.PAIR_DIM) and state["fc3.bias"].shape == (1,)
    assert all(v.dtype == torch.float32 for v in state.values())
    back = lt.params_from_scorer(lt.scorer_from_params(packaged))
    assert sorted(back) == sorted(PARAM_KEYS)
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(back[k], np.asarray(packaged[k], np.float32))
        assert back[k].shape == np.asarray(packaged[k]).shape


@pytest.mark.parametrize("kind,seed", [("hela", 0), ("hela", 5), ("synthetic", 2),
                                       ("synthetic", 11)])
def test_link_and_track_match_jax(packaged, kind, seed):
    from micro_sam_tpu import learned_tracking as jlt
    from micro_sam_tpu_torch import learned_tracking as lt
    port, jax_ = _trackers(packaged)
    images, segs, _ = _sequence(kind, seed)
    assert lt.estimate_linking_signals(segs) == jlt.estimate_linking_signals(segs)
    assert lt.choose_linker(segs) == jlt.choose_linker(segs)
    assert port.link_auto(segs, images) == jax_.link_auto(segs, images)
    assert port.link(segs, images) == jax_.link(segs, images)
    assert port.last_confidence == pytest.approx(jax_.last_confidence, rel=1e-6)
    got, got_pg = port.track(images, segs)
    ref, ref_pg = jax_.track(images, segs)
    np.testing.assert_array_equal(got, ref)
    assert got_pg == ref_pg
    # a lower division bar: more second children
    port, jax_ = _trackers(packaged, division_threshold=-1.0)
    assert port.link(segs, images) == jax_.link(segs, images)


@pytest.mark.parametrize("regime", ["slow_drift", "fast_drift", "occlusion_gap2",
                                    "birth_death_churn", "dense_touching"])
def test_regimes_match_jax(packaged, regime):
    """estimate_linking_signals, choose_linker, link_auto and
    track_with_fallback on a HeLa-like sequence of each regime, and
    evaluate_tracking of the links."""
    from micro_sam_tpu import learned_tracking as jlt
    from micro_sam_tpu_torch import learned_tracking as lt
    assert lt.TRACKING_REGIMES == jlt.TRACKING_REGIMES
    images, segs, links = lt.hela_like_tracking_sequence(n_frames=10, seed=1000,
                                                         **lt.TRACKING_REGIMES[regime])
    assert lt.estimate_linking_signals(segs) == jlt.estimate_linking_signals(segs)
    assert lt.choose_linker(segs) == jlt.choose_linker(segs)
    port, jax_ = _trackers(packaged)
    got = port.link_auto(segs, images)
    assert got == jax_.link_auto(segs, images)
    n2t, pg, _ = got
    assert lt.evaluate_tracking(segs, links, n2t, pg) == jlt.evaluate_tracking(segs, links, n2t,
                                                                               pg)
    tracked, pg, used_greedy = port.track_with_fallback(images, segs)
    ref = jax_.track_with_fallback(images, segs)
    np.testing.assert_array_equal(tracked, ref[0])
    assert (pg, used_greedy) == ref[1:]
    assert lt.greedy_node_to_track(segs) == jlt.greedy_node_to_track(segs)


def test_evaluate_regimes_matches_jax():
    from micro_sam_tpu import learned_tracking as jlt
    from micro_sam_tpu_torch import learned_tracking as lt
    regimes = {k: lt.TRACKING_REGIMES[k] for k in ("slow_drift", "occlusion_gap2")}
    got = lt.evaluate_regimes(n_seeds=1, n_frames=6, regimes=regimes, device="cpu")
    assert got == jlt.evaluate_regimes(n_seeds=1, n_frames=6, regimes=regimes)


def test_sequences_and_pairs_match_jax():
    from micro_sam_tpu import learned_tracking as jlt
    from micro_sam_tpu_torch import learned_tracking as lt
    for gen, kw in ((lt.synthetic_tracking_sequence, dict(seed=4, division_prob=0.3)),
                    (lt.hela_like_tracking_sequence,
                     dict(seed=2, occlusion_prob=0.2, birth_prob=0.5, death_prob=0.1,
                          return_events=True))):
        got, ref = gen(**kw), getattr(jlt, gen.__name__)(**kw)
        for g, r in zip(got, ref):
            if isinstance(g, np.ndarray):
                np.testing.assert_array_equal(g, r)
            else:
                assert g == r
    images, segs, links = lt.synthetic_tracking_sequence(seed=4, division_prob=0.3)
    got = lt.build_training_pairs(images, segs, links)
    ref = jlt.build_training_pairs(images, segs, links)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_train_linker_matches_optax(monkeypatch):
    """50 full-batch Adam steps from JAX's initial weights (the port's
    initialisation patched to hand them over): every parameter within rel
    1e-4 of optax's."""
    import jax
    from micro_sam_tpu import learned_tracking as jlt
    from micro_sam_tpu_torch import learned_tracking as lt
    images, segs, links = lt.synthetic_tracking_sequence(seed=3, division_prob=0.1)
    pairs, labels = lt.build_training_pairs(images, segs, links)
    init = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jlt.init_linker_params(jax.random.PRNGKey(0), 64))
    monkeypatch.setattr(lt, "init_linker_params",
                        lambda generator, hidden=64: {k: v.copy() for k, v in init.items()})
    got = lt.train_linker(pairs, labels, n_steps=50, seed=0, device="cpu")
    ref = jlt.train_linker(pairs, labels, n_steps=50, seed=0)
    for k in PARAM_KEYS:
        assert got[k].shape == np.asarray(ref[k]).shape and got[k].dtype == np.float32
        assert rel_err(got[k], ref[k]) <= 1e-4, k
    np.testing.assert_array_equal(got["mu"], pairs.mean(axis=0).astype(np.float32))
    assert rel_err(got["w1"], init["w1"]) > 1e-2  # it trained


def test_train_linker_learns_and_uses_its_generator():
    from micro_sam_tpu_torch import learned_tracking as lt
    a = lt.init_linker_params(torch.Generator().manual_seed(5))
    b = lt.init_linker_params(torch.Generator().manual_seed(5))
    assert all(np.array_equal(a[k], b[k]) for k in PARAM_KEYS)
    assert a["w1"].shape == (lt.PAIR_DIM, 64) and a["w3"].shape == (64, 1)
    images, segs, links = lt.synthetic_tracking_sequence(seed=3, division_prob=0.1)
    pairs, labels = lt.build_training_pairs(images, segs, links)
    params = lt.train_linker(pairs, labels, n_steps=200, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    logits = lt.linker_apply(params, pairs)
    assert ((logits > 0) == (labels > 0.5)).mean() > 0.97


def test_save_load_round_trip(packaged, tmp_path):
    from micro_sam_tpu import learned_tracking as jlt
    from micro_sam_tpu_torch import learned_tracking as lt
    path = str(tmp_path / "linker.npz")
    lt.save_linker(path, packaged)
    loaded = lt.load_linker(path)
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(loaded[k], packaged[k])
    # the JAX package reads it, and from_pretrained takes the path
    assert sorted(jlt.load_linker(path)) == sorted(PARAM_KEYS)
    images, segs, _ = _sequence("hela", 4)
    tracker = lt.LearnedTracker.from_pretrained(path, device="cpu")
    assert tracker.link(segs, images) == _trackers(packaged)[0].link(segs, images)
    with pytest.raises(ValueError, match="Unknown pretrained"):
        lt.LearnedTracker.from_pretrained("nonsense", device="cpu")


@pytest.mark.parametrize("tracker", ["learned", "auto"])
def test_track_across_frames_with_tracker_matches_jax(packaged, tracker):
    from micro_sam_tpu import multi_dimensional_segmentation as jm
    from micro_sam_tpu_torch import multi_dimensional_segmentation as pm
    images, segs, _ = _sequence("hela", 6, division_prob=0.2)
    kw = dict(verbose=False, min_time_extent=2)
    got, got_lin = pm.track_across_frames(images, segs, tracker=tracker, device="cpu", **kw)
    ref, ref_lin = jm.track_across_frames(images, segs, tracker=tracker, **kw)
    np.testing.assert_array_equal(got, ref)
    assert got_lin == ref_lin and [list(d) for d in got_lin] == [list(d) for d in ref_lin]
    if tracker == "learned":  # a tracker instance takes the place of the name
        again, again_lin = pm.track_across_frames(images, segs, tracker=_trackers(packaged)[0],
                                                  **kw)
        np.testing.assert_array_equal(again, got)
        assert again_lin == got_lin


def test_tracker_wants_the_card(packaged):
    """Without a device the tracker wants the GPU and raises without one."""
    from micro_sam_tpu_torch import learned_tracking as lt
    from micro_sam_tpu_torch import multi_dimensional_segmentation as pm
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lt.LearnedTracker(packaged)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lt.LearnedTracker.from_pretrained("default")
    images, segs, _ = _sequence("hela", 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pm.track_across_frames(images, segs, tracker="learned", verbose=False)
