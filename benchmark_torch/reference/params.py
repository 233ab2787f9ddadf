"""The parameter tree the benchmark serves and trains, drawn from the seed.

The layout is DESIRE's, as both the program and the reference read it:
dense weights (in, out) with bias "b"; a GRU as {"wi" (in, 3H), "wh" (H, 3H),
"bi", "bh"} with its gates in [r | z | n] order; convolutions HWIO; group
norms {"scale", "bias"}. Only the layer shapes of a configuration enter
here (``shapes``); every value comes from one seeded generator on the
device, in one draw, so that the weights are the benchmark's own and not
anything the program made.
"""

from __future__ import annotations

import math

import torch


def _dense(i, o):
    return {"w": (i, o), "b": (o,)}


def _gru(i, h):
    return {"wi": (i, 3 * h), "wh": (h, 3 * h), "bi": (3 * h,),
            "bh": (3 * h,)}


def _conv(k, ci, co):
    return {"w": (k, k, ci, co), "b": (co,)}


def _gn(c):
    return {"scale": (c,), "bias": (c,)}


def shapes(cfg: dict) -> dict:
    """The tree of leaf shapes of a configuration (its DesireConfig fields
    as a dict, the benchmark's configuration file's ``model``)."""
    d, emb, lat = cfg["d_dim"], cfg["embedding_size"], cfg["latent_size"]
    cm, to = cfg["channel_multiplier"], cfg["obs_len"]
    side = math.isqrt(2 * cfg["rnn_size"])
    c, nl = cfg["scene_channels"], cfg["num_layers"]
    in_f = 5 if cfg["input_norm"] else 4
    sgm = {
        "embed_x": _dense(in_f, emb), "embed_y": _dense(in_f, emb),
        "enc_x": [_gru(emb if i == 0 else d, d) for i in range(nl)],
        "enc_y": [_gru(emb if i == 0 else d, d) for i in range(nl)],
        "temporal_w": (to, 2, cm), "temporal_b": (2 * cm,),
        "fuse": _dense(2 * d, side * side),
        "post_vae": _dense(side * side, d),
        "z_gate": _dense(lat, d), "z_skip": _dense(lat, d),
        "rho_proj": _dense(2 * cm, d),
        "dec": [_gru(d, d) for _ in range(nl)],
        "head": _dense(d, 5),
    }
    if cfg["cond_prior"]:
        sgm["prior"] = _dense(d, 2 * lat)
    if cfg["speed_norm"] and cfg["learn_bound"]:
        sgm["vel_gain_log"] = ()
        sgm["vel_floor_log"] = ()
        if cfg["aniso_bound"]:
            raise ValueError("aniso_bound is not in the reference")
    if cfg["pace_range"] > 0:
        raise ValueError("pace_range is not in the reference")
    if cfg["z_temp_learn"]:
        sgm["ztemp_fc1"] = _dense(1, 8)
        sgm["ztemp_fc2"] = _dense(8, 1)
    if side != 32:
        raise ValueError("the reference has the conv recognition network "
                         "only (vae side 32)")
    sgm.update(venc1=_conv(5, 1, 32), vgn1=_gn(32), venc2=_conv(5, 32, 64),
               vgn2=_gn(64), venc3=_conv(5, 64, 128), vgn3=_gn(128),
               venc_fc=_dense((side // 8) ** 2 * 128, 2 * lat))
    if cfg["vae_dec"] == "conv":
        sgm.update(vdec1=_conv(4, lat, 128), vdgn1=_gn(128),
                   vdec2=_conv(5, 128, 64), vdgn2=_gn(64),
                   vdec3=_conv(5, 64, 32), vdgn3=_gn(32),
                   vdec4=_conv(5, 32, 1))
    else:
        hid = max(4 * lat, side * side // 2)
        sgm.update(vdec_fc1=_dense(lat, hid), vdec_fc=_dense(hid, side * side))
    c_in = 2 + cfg["scene_image_channels"]
    scf = {"conv1": _conv(3, c_in, c), "gn1": _gn(c), "conv2": _conv(3, c, c),
           "gn2": _gn(c), "soc_msg": _dense(d, d), "soc_logtau": ()}
    ioc = {"gru": [_gru(2 + c + 2 * d, d)], "score": _dense(d, 1),
           "delta": _dense(d, 2), "gate": _dense(d, 1)}
    return {"sgm": sgm, "scf": scf, "ioc": ioc}


def _paths(tree, prefix=""):
    """(path, shape) of every leaf, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tuple(tree)


def _set(tree, path, value):
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node[int(k)] if isinstance(node, list) else node[k]
    last = keys[-1]
    if isinstance(node, list):
        node[int(last)] = value
    else:
        node[last] = value


def _copy_structure(tree):
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_structure(v) for v in tree]
    return None


# leaves whose value is a level, not a weight: (mean, spread)
_LEVELS = {"sgm/vel_gain_log": (math.log(2.0), 0.1),
           "sgm/vel_floor_log": (math.log(0.004), 0.1),
           "scf/soc_logtau": (math.log(0.05), 0.1)}
# heads kept small, as a trained model's are: the sampler's residual head
# and the refinement's delta and gate heads (non-zero, so that every refine
# pass moves the hypotheses)
_GAIN = {"sgm/head/w": 0.05, "ioc/delta/w": 0.3, "ioc/gate/w": 0.3}


def make_params(cfg: dict, seed: int, device) -> dict:
    """Float32 parameters of cfg's shapes from one standard-normal draw of
    a generator on ``device`` seeded with ``seed``: weights scaled by
    1/sqrt(fan in), biases by 0.1, group-norm scales around 1, the learned
    levels around their configured values."""
    leaves = list(_paths(shapes(cfg)))
    sizes = [math.prod(s) for _, s in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    tree = _copy_structure(shapes(cfg))
    for (path, shape), x in zip(leaves, torch.split(flat, sizes)):
        x = x.reshape(shape)
        name = path.rsplit("/", 1)[-1]
        if path in _LEVELS:
            mean, spread = _LEVELS[path]
            x = mean + spread * x
        elif name == "scale":
            x = 1.0 + 0.1 * x
        elif len(shape) == 1:
            x = 0.1 * x
        else:
            x = x * (_GAIN.get(path, 1.0) / math.sqrt(math.prod(shape[:-1])))
        _set(tree, path, x.contiguous())
    return tree


def leaves(tree) -> list:
    """The leaves in path order (dict keys sorted), as ``shapes`` lists
    them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(like, values):
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)
    return build(like)
