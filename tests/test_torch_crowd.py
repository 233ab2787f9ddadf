"""DESIRE with more than 64 agents a scene, on the CPU at toy widths: the
port's forward at 72 agent slots against the benchmark's plain float32
reference (``benchmark_torch/reference/model.py``) on the same seeded
weights and pinned noise; ``Predictor`` answering a crowded window and a
sparse one in one request; and the limits the kernels state before any
launch: the tensor-core IOC layout up to 128 agents, and the fused IOC
backward's shared memory (``BwdLayout``)."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark_torch.reference import model as ref
from benchmark_torch.reference import params as ref_params
from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.models.desire import desire_forward
from desire_tpu_torch.ops import ioc_bwd, ioc_fused
from desire_tpu_torch.serve import Predictor

# the crowd configuration's toy block (benchmark_torch/configs/
# desire_crowd128.json) at fewer steps: 72 agent slots, past the 64 a
# tensor-core lane held before
_TOY = dict(max_num_obj=72, obs_len=4, pred_len=4, d_dim=16, latent_size=8,
            embedding_size=8, channel_multiplier=8, rnn_size=512,
            scene_grid=8, scene_channels=8, num_refine=2,
            compute_dtype="float32", use_pallas=True)


def _model_cfg():
    return dict(dataclasses.asdict(DesireConfig()), **_TOY)


def _walks(rng, b, t, a, live):
    """(B, T, A, 2) positions in [0.1, 0.9] walking straight, mask and ids
    with the first ``live`` agents of each window present."""
    p0 = rng.uniform(0.2, 0.8, (b, 1, a, 2))
    v = rng.uniform(-0.02, 0.02, (b, 1, a, 2))
    xy = p0 + v * np.arange(t)[None, :, None, None]
    mask = np.zeros((b, t, a), np.float32)
    mask[:, :, :live] = 1.0
    ids = np.zeros((b, a), np.int64)
    ids[:, :live] = np.arange(1, live + 1)
    return (torch.as_tensor(xy * mask[..., None], dtype=torch.float32),
            torch.as_tensor(mask), torch.as_tensor(ids))


@pytest.mark.parametrize("live", [72, 40])
def test_forward_at_72_agents_matches_the_reference(live):
    model = _model_cfg()
    cfg = DesireConfig(**_TOY)
    params = ref_params.make_params(model, 7, torch.device("cpu"))
    rng = np.random.default_rng(live)
    b, k = 2, 3
    xy, mask, ids = _walks(rng, b, cfg.obs_len + cfg.pred_len, 72, live)
    eps = torch.as_tensor(rng.standard_normal((b * 72, k, cfg.latent_size)),
                          dtype=torch.float32)
    got = desire_forward(params, cfg, xy, mask, ids, eps=eps, k_samples=k,
                         train=False)
    want = ref.forward(params, model, xy, mask, ids, eps)
    assert got["refined_traj"].shape == (b, 72, k, cfg.pred_len, 2)
    np.testing.assert_allclose(got["refined_traj"].numpy(),
                               want["refined"].numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["scores"].float().numpy(),
                               want["scores"].numpy(), rtol=1e-4,
                               atol=1e-4)


def test_predictor_answers_a_crowd_and_a_few_in_one_request():
    cfg = DesireConfig(**_TOY)
    params = ref_params.make_params(_model_cfg(), 3, torch.device("cpu"))
    pred = Predictor(params, cfg, device="cpu", k_samples=3, max_windows=2,
                     seed=0)
    rng = np.random.default_rng(0)
    wins = []
    for n in (72, 5):
        xy = rng.uniform(100.0, 900.0, (n, 1, 2)) + rng.uniform(
            -10.0, 10.0, (n, 1, 2)) * np.arange(cfg.obs_len)[None, :, None]
        wins.append((xy.astype(np.float32),
                     np.ones((n, cfg.obs_len), np.float32),
                     np.arange(1, n + 1, dtype=np.int64)))
    out = pred.predict_windows(wins, scales=1000.0)
    assert [len(o["ids"]) for o in out] == [72, 5]
    assert [int(o["live"].sum()) for o in out] == [72, 5]
    for o, n in zip(out, (72, 5)):
        assert o["traj"].shape == (n, 3, cfg.pred_len, 2)
        assert o["best"].shape == (n, cfg.pred_len, 2)
        assert np.isfinite(o["traj"]).all()
        assert np.isfinite(o["scores"]).all()


def _ioc_trees(d=48, c=32):
    cfg = DesireConfig(**dict(_TOY, d_dim=d, scene_channels=c))
    params = ref_params.make_params(dict(_model_cfg(), d_dim=d,
                                         scene_channels=c), 0,
                                    torch.device("cpu"))
    return cfg, params


@pytest.mark.parametrize("agents", [1, 60, 64, 65, 96, 128])
def test_pack_ioc_takes_the_tensor_core_layout_up_to_128(agents):
    _, p = _ioc_trees()
    w = ioc_fused.pack_ioc(p["ioc"], p["scf"], torch.bfloat16, "cpu", agents)
    assert w.use_mma and w.max_agents == agents
    assert not ioc_fused.pack_ioc(p["ioc"], p["scf"], torch.float32, "cpu",
                                  agents).use_mma


def test_pack_ioc_refuses_129_agents_naming_the_limit():
    _, p = _ioc_trees()
    with pytest.raises(ValueError, match="at most 128"):
        ioc_fused.pack_ioc(p["ioc"], p["scf"], torch.bfloat16, "cpu", 129)
    # the CUDA-core widths keep their own path
    _, p8 = _ioc_trees(c=8)
    assert not ioc_fused.pack_ioc(p8["ioc"], p8["scf"], torch.bfloat16,
                                  "cpu", 129).use_mma


class _BwdLibrary:
    """The kernel library's two answers on BwdLayout, as the card's
    library gives them at the flagship's widths (64 agents a lane)."""

    @staticmethod
    def ioc_refine_bwd_max_agents(t, d, c, g, bf16):
        return 64

    @staticmethod
    def ioc_refine_bwd_smem_bytes(a, t, d, c, g, bf16):
        return 3800 * a


@pytest.mark.parametrize("agents,fits", [(60, True), (61, True),
                                         (64, True), (65, False),
                                         (128, False)])
def test_the_backward_layout_limit_is_named_before_any_launch(
        agents, fits, monkeypatch):
    """Past the agents BwdLayout holds, the check names the layout and
    its limit (the card test holds the library's count)."""
    from desire_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "library", _BwdLibrary)
    ioc_bwd.check_bwd_agents.cache_clear()
    args = (agents, 12, 48, 32, 32, True)
    try:
        if fits:
            ioc_bwd.check_bwd_agents(*args)
            return
        with pytest.raises(ValueError,
                           match=r"BwdLayout.*at most 64 agents"):
            ioc_bwd.check_bwd_agents(*args)
    finally:
        ioc_bwd.check_bwd_agents.cache_clear()
