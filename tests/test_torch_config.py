"""The port's own DesireConfig against the JAX package's, field for field,
and the port's import isolation: it imports neither JAX nor anything of
the JAX package."""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from desire_tpu import config as jconfig
from desire_tpu_torch import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fields_and_defaults_match():
    jf = [(f.name, f.type, f.default) for f in
          dataclasses.fields(jconfig.DesireConfig)]
    tf = [(f.name, f.type, f.default) for f in
          dataclasses.fields(tconfig.DesireConfig)]
    assert tf == jf
    # the port's copy adds the prior-lane keys the JAX dict lacks (an old
    # config.json resumes without prior lanes), nothing else
    assert tconfig._PRE_FEATURE_DEFAULTS == dict(
        jconfig._PRE_FEATURE_DEFAULTS, prior_lane_frac=0.0, w_prior_nll=0.0)


def test_old_config_loads_without_prior_lanes():
    """A config.json written before prior_lane_frac and w_prior_nll existed
    loads into the port with both at 0.0, not today's defaults."""
    new = tconfig.DesireConfig()
    assert new.prior_lane_frac > 0 and new.w_prior_nll > 0
    d = json.loads(new.to_json())
    del d["prior_lane_frac"], d["w_prior_nll"]
    old = tconfig.DesireConfig.from_json(json.dumps(d))
    assert old.prior_lane_frac == 0.0 and old.w_prior_nll == 0.0
    # every other field as saved
    assert old.replace(prior_lane_frac=new.prior_lane_frac,
                       w_prior_nll=new.w_prior_nll) == new


@pytest.mark.parametrize("kw", [
    {}, dict(batch_size=64, max_num_obj=60, num_samples=20, d_dim=48,
             latent_size=128, compute_dtype="bfloat16", num_refine=4),
    dict(protocol="compat", rnn_size=50, use_social=False)])
def test_to_json_and_properties_match(kw):
    j, t = jconfig.DesireConfig(**kw), tconfig.DesireConfig(**kw)
    assert t.to_json() == j.to_json()
    for name, attr in vars(jconfig.DesireConfig).items():
        if isinstance(attr, property):
            assert getattr(t, name) == getattr(j, name), name
    assert t.replace(seed=3).to_json() == j.replace(seed=3).to_json()


def test_jax_json_loads_with_absent_key_backfill():
    """A config saved by the JAX package loads in the port; keys absent
    from it (an older checkpoint) take their pre-feature values."""
    d = json.loads(jconfig.DesireConfig(num_samples=7).to_json())
    assert tconfig.DesireConfig.from_json(json.dumps(d)).to_json() \
        == jconfig.DesireConfig.from_json(json.dumps(d)).to_json()
    for k in jconfig._PRE_FEATURE_DEFAULTS:
        del d[k]
    d["a_key_from_the_future"] = 1
    old_t = tconfig.DesireConfig.from_json(json.dumps(d))
    old_j = jconfig.DesireConfig.from_json(json.dumps(d))
    assert old_t.to_json() == old_j.to_json()
    for k, legacy in jconfig._PRE_FEATURE_DEFAULTS.items():
        assert getattr(old_t, k) == legacy, k


def test_validation_matches():
    for bad in (dict(model="lstm"), dict(holdout="scene"),
                dict(vae_dec="deconv"), dict(rnn_size=100)):
        for mod in (jconfig, tconfig):
            with pytest.raises(ValueError):
                mod.DesireConfig(**bad)


def test_flags_match():
    argv = ["--num_samples", "9", "--use_social", "false", "--d_dim", "32"]
    cfgs = []
    for mod in (jconfig, tconfig):
        parser = argparse.ArgumentParser()
        mod.add_config_flags(parser)
        cfgs.append(mod.config_from_args(parser.parse_args(argv)))
    assert cfgs[1].to_json() == cfgs[0].to_json()


def test_port_imports_no_jax():
    """In a fresh interpreter: desire_tpu_torch, all its submodules (the
    data loader, the eval harness, the checkpoint, the parallel mesh, the
    training, evaluation and forecasting entry points, the serving bench,
    the headline bench and the constant-velocity baseline by name, the
    reference facade and the toy example),
    and chip_smoke, and then neither jax nor desire_tpu is loaded."""
    code = """
import importlib, pkgutil, sys
import desire_tpu_torch
import desire_tpu_torch.data.loader
import desire_tpu_torch.eval.sampler
import desire_tpu_torch.train.checkpoint
import desire_tpu_torch.parallel.mesh
import desire_tpu_torch.train.run
import desire_tpu_torch.evaluate
import desire_tpu_torch.predict
import desire_tpu_torch.bench_serve
import desire_tpu_torch.bench
import desire_tpu_torch.baseline_cv
import desire_tpu_torch.compat
import desire_tpu_torch.examples.toy_gaussian
for m in pkgutil.walk_packages(desire_tpu_torch.__path__, "desire_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib"))
             or n == "desire_tpu" or n.startswith("desire_tpu."))
assert not bad, bad
print(len([n for n in sys.modules if n.startswith("desire_tpu_torch")]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 25
