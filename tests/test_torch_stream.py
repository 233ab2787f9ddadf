"""The port's StreamServer (desire_tpu_torch/serve.py) against the JAX
package's: the windows it hands to the predictor over one frame feed
(off-grid frames, late and vanishing agents, id 0, more agents than
slots) are bit for bit the JAX server's, and the JAX serving tests of its
schedule and eviction (tests/test_serve.py), mirrored on the port's
Predictor on the CPU."""

import json

import numpy as np
import pytest
import torch

from desire_tpu.config import DesireConfig as JConfig
from desire_tpu.serve import StreamServer as JStreamServer
from desire_tpu_torch.config import DesireConfig as TConfig
from desire_tpu_torch.params import init_desire
from desire_tpu_torch.serve import (Predictor, StreamServer,
                                    forecast_to_json)

# tests/test_serve.py's toy model
_TOY = dict(batch_size=4, max_num_obj=8, obs_len=4, pred_len=4,
            subsample=2, window_hop=2, num_samples=3, d_dim=16,
            latent_size=8, embedding_size=8, channel_multiplier=10,
            scene_grid=8, scene_channels=4, num_refine=2,
            compute_dtype="float32", save_dir="", seed=0)


class _StubPredictor:
    """Records the windows a server hands to predict()."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.obs_len = cfg.obs_len
        self.calls = []

    def predict(self, obs_xy, obs_mask, ids, scale=1.0):
        self.calls.append((obs_xy.copy(), obs_mask.copy(), ids.copy(),
                           scale))
        return {"ids": ids}


def _feed(seed=0, frames=60):
    """A frame feed from frame 7 on: 12 agents (more than the 8 slots)
    that enter and leave at random frames, one gap longer than a window,
    id 0 sentinels, float pixel positions."""
    rng = np.random.default_rng(seed)
    enter = rng.integers(0, frames // 2, 12)
    leave = enter + rng.integers(6, frames, 12)
    p0 = rng.uniform(0, 500, (12, 2))
    v = rng.uniform(-3, 3, (12, 2))
    feed = []
    for f in range(7, 7 + frames):
        agents = [(i + 1, *(p0[i] + v[i] * f)) for i in range(12)
                  if enter[i] <= f - 7 < leave[i]
                  and not (i == 3 and 20 <= f - 7 < 32)]
        if f % 5 == 0:
            agents.append((0, 1.0, 2.0))
        rng.shuffle(agents)
        feed.append((f, agents))
    return feed


def test_stream_windows_match_jax_bit_for_bit():
    jc, tc = JConfig(**_TOY), TConfig(**_TOY)
    pj, pt = _StubPredictor(jc), _StubPredictor(tc)
    sj, st = JStreamServer(pj, scale=120.0), StreamServer(pt, scale=120.0)
    emitted = 0
    for f, agents in _feed():
        oj, ot = sj.observe(f, agents), st.observe(f, agents)
        assert (oj is None) == (ot is None), f
        if oj is not None:
            emitted += 1
            assert (ot["frame"], ot["step"]) == (oj["frame"], oj["step"])
            np.testing.assert_array_equal(ot["ids"], oj["ids"])
        assert sorted(st.hist) == sorted(sj.hist)
        assert st.step == sj.step
    assert emitted > 10 and len(pt.calls) == len(pj.calls) == emitted
    # windows truncated to the slots, at least once
    assert max(len(c[2]) for c in pt.calls) == tc.max_num_obj
    for (xt, mt, it, st_), (xj, mj, ij, sj_) in zip(pt.calls, pj.calls):
        for got, ref in ((xt, xj), (mt, mj), (it, ij)):
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)
        assert st_ == sj_


@pytest.fixture(scope="module")
def pred():
    cfg = TConfig(**_TOY)
    params = init_desire(cfg, torch.Generator().manual_seed(0), "cpu")
    return Predictor(params, cfg, device="cpu", max_windows=2, seed=1)


def test_stream_server_emits_on_schedule(pred):
    cfg = pred.cfg
    sub = cfg.subsample
    srv = StreamServer(pred, scale=100.0)
    v = np.array([1.5, -0.8], np.float32)
    outs = []
    for f in range(0, cfg.obs_len * sub + sub, 1):     # with off-grid ones
        agents = [(5, 40 + v[0] * f, 50 + v[1] * f),
                  (9, 60 - v[0] * f, 30 + v[1] * f)]
        out = srv.observe(f, agents)
        if (f % sub) or (f // sub) + 1 < cfg.obs_len:
            assert out is None        # off the grid or too little history
        else:
            assert out is not None
            outs.append(out)
    assert len(outs) == 2                # steps obs_len - 1 and obs_len
    assert sorted(outs[0]["ids"].tolist()) == [5, 9]
    assert outs[0]["step"] == cfg.obs_len - 1
    assert outs[1]["frame"] == cfg.obs_len * sub
    rec = json.loads(forecast_to_json(outs[-1], top_k=2))
    assert len(rec["agents"]) == 2
    assert len(rec["agents"][0]["hypotheses"]) == 2
    assert len(rec["agents"][0]["top1"]) == cfg.pred_len


def test_stream_server_evicts_stale_agents(pred):
    cfg = pred.cfg
    sub = cfg.subsample
    srv = StreamServer(pred, scale=100.0)
    for f in range(0, 2 * sub, sub):                  # agent 7 seen twice
        srv.observe(f, [(7, 10 + f, 10), (8, 90, 90 - f)])
    for f in range(2 * sub, (2 + cfg.obs_len) * sub, sub):  # then gone
        out = srv.observe(f, [(8, 90, 90 - f)])
    assert 7 not in srv.hist
    assert out is not None and out["ids"].tolist() == [8]
