"""The training loss as CUDA graphs around the eager IOC
(``train.trainer.make_train_step``'s step on the card).

Launched one kernel at a time, the loss's forward and backward are
thousands of small launches, and the card waits for the host. The graphed
step captures the two launch-heavy stages of ``models.desire.desire_loss``
once, forward and backward, and replays them every step:

* encode (``desire.loss_encode``): the SGM training forward and the scene
  feature map;
* the loss tail (``desire.loss_tail``): every term after the IOC.

The IOC between them (``desire.loss_refine``: ``ops.ioc_refine_train``,
looked up at call time, whose backward calls
``ops.ioc_bwd.ioc_refine_bwd_cuda``) stays an eager call: a handful of
launches, which a reader of the calls' device time ranges. A step copies
its inputs into the graphs' static buffers (the parameters in one copy:
the static params are a buffer in the layout of the state's
``TrainState.flat``), replays the encode forward, runs the IOC forward,
copies its outputs in, replays the tail's forward and backward, runs the
IOC's backward (autograd from its outputs), copies its input gradients in
and replays the encode backward. Each stage's outputs are the next one's inputs where both are
graphs (the tail reads encode's outputs in place), cut from the
preceding stage's autograd graph.

The capture happens once, at the first call, under the span
``setup.train_graphs``: ``WARMUP`` eager passes of the same stages (the
libraries' handles, the autograd threads; the IOC's forward gives the
tail its inputs there, its backward is left out), then the four graphs
on a side stream in the order they replay, in one memory pool, which
stays reserved while the step function lives (once it is dropped, the
allocator frees the pool at ``torch.cuda.empty_cache``). No
random draw may happen inside a capture (``_NoDraws``): every draw of the
step is an input (``trainer.step_noise``), and the step count of the KLD
warm-up is a tensor. The counters and kernel launch counts the warm-up
and the captures add are taken back, and every replay adds what its
capture counted, so a graphed step counts what an eager one does
(``telemetry.add_tally``).

The returned metrics are one copy of the tail's static outputs a step,
and the gradients of the encode's parameters are the graph's static
buffers, valid until the next step. On the CPU (tests) the stages run
eagerly, as in the warm-up, on the step's own leaves: no graph holds
their addresses, so nothing is copied in.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

from desire_tpu_torch.models import desire
from desire_tpu_torch.train.state import tree_leaves, tree_unflatten
from desire_tpu_torch.utils import telemetry

WARMUP = 2

# the step's draws that enter the graphs as inputs
_NOISE = ("eps", "keep_x", "keep_y", "lane_u")
# the IOC's inputs among the encode's outputs, and those with a gradient
_IOC_IN = ("sgm_traj", "dec_h", "feat_map", "live", "fut_mask")
_IOC_GRAD = ("sgm_traj", "dec_h", "feat_map")
# the graphs, in the order they are captured and replayed
_STAGES = ("encode_fwd", "tail_fwd", "tail_bwd", "encode_bwd")

# torch functions and tensor methods that draw random numbers
_DRAWS = frozenset((
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "bernoulli", "bernoulli_", "multinomial", "normal",
    "normal_", "uniform_", "random_", "exponential_", "geometric_",
    "log_normal_", "cauchy_", "poisson", "dropout", "dropout_",
    "alpha_dropout", "feature_alpha_dropout", "dropout1d", "dropout2d",
    "dropout3d", "rrelu"))


class _NoDraws(TorchFunctionMode):
    """Raise on a random draw: a graph would replay the captured one."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in _DRAWS:
            raise RuntimeError(
                f"a random draw ({name}) inside a CUDA graph capture of the "
                f"training loss: the step's draws are its inputs "
                f"(trainer.step_noise)")
        return func(*args, **(kwargs or {}))


def _vjp(pairs, inputs):
    """The gradients with respect to ``inputs`` of the (output, cotangent)
    ``pairs``: autograd from the sum of each output times its cotangent,
    whose gradient at an output is its cotangent times one, exactly. A
    cotangent handed to ``torch.autograd.grad`` itself would be checked by
    importing PyTorch's symbolic-shape module, seconds at a process's
    first step."""
    terms = [(o * g).sum() for o, g in pairs]
    return torch.autograd.grad(sum(terms[1:], terms[0]), inputs,
                               allow_unused=True)


def batch_shape(xy, img=None) -> tuple:
    """What a capture is made for: the batch's shape and its raster's."""
    return tuple(xy.shape), None if img is None else tuple(img.shape)


def engages(cfg, *, cuda, mesh, shape, captured=None) -> bool:
    """Whether a training step takes the graphed loss: the batch on CUDA,
    no mesh (under one the loss all-sums its normalisers inside the
    forward), the fused training IOC without remat, and a batch of the
    captured ``batch_shape`` (any, before the first capture)."""
    return (bool(cuda) and mesh is None
            and desire.uses_fused_train_ioc(cfg) and not cfg.remat
            and (captured is None or tuple(shape) == tuple(captured)))


class GraphedLoss:
    """``desire_loss`` and its gradients for batches of one shape: the
    encode and tail stages as CUDA graphs, forward and backward, around
    the eager IOC (the module's docstring). ``capture`` once, then
    ``forward`` and ``backward`` each step, from the training state
    (``train.state.TrainState``) whose params the loss reads."""

    def __init__(self, cfg, state, xy, mask, ids, img, noise):
        self.cfg = cfg
        self.shape = batch_shape(xy, img)
        self.like = state.params
        dev = xy.device
        self.flat = self.leaves = None
        if state.flat is not None:
            # the static params: a buffer in the layout of the state's,
            # whose params arrive in one copy
            self.flat = torch.empty_like(state.flat.params)
            self.leaves = [x.requires_grad_(True)
                           for x in state.flat.layout.views(self.flat)]
        batch = {"xy": xy, "mask": mask, "ids": ids, "img": img}
        batch.update((k, noise.get(k)) for k in _NOISE)
        if batch["lane_u"] is None or batch["eps"] is None or (
                cfg.keep_prob < 1.0 and (batch["keep_x"] is None
                                         or batch["keep_y"] is None)):
            raise ValueError("the graphed loss takes every draw of the step "
                             "as an input (trainer.step_noise)")
        self.inputs = {k: torch.empty_like(v) for k, v in batch.items()
                       if v is not None}
        self.step = torch.zeros((), dtype=torch.float32, device=dev)
        self.graphs = None
        self.counts = {}
        self.t_out = None       # the tail's inputs from the IOC
        self.g_ioc = {}         # the encode's output gradients from the IOC
        self.zeros = {}
        self.ioc_out = None

    # -- the stages ------------------------------------------------------

    def _encode_fwd(self):
        inp = self.inputs
        enc = desire.loss_encode(
            tree_unflatten(self.like, self.leaves), self.cfg, inp["xy"],
            inp["mask"], inp["ids"], k_samples=self.cfg.num_samples,
            noise={k: inp[k] for k in ("eps", "keep_x", "keep_y")
                   if k in inp},
            scene_image=inp.get("img"))
        self.enc = enc
        self.grad_keys = [k for k, v in enc.items()
                          if torch.is_tensor(v) and v.requires_grad]

        def cut(k):     # the same memory, a leaf of the next stage
            v = enc[k]
            return v.detach().requires_grad_(True) if k in self.grad_keys \
                else v
        self.ioc_in = {k: cut(k) for k in _IOC_IN}
        self.tail_in = {k: cut(k) for k in enc
                        if k not in ("dec_h", "feat_map")}

    def _refine_fwd(self, params):
        refined, scores, per_iter = desire.loss_refine(params, self.cfg,
                                                       self.ioc_in)
        self.ioc_out = [refined, scores, *per_iter]
        if self.t_out is None:
            self.t_out = [torch.empty_like(x).requires_grad_(True)
                          for x in self.ioc_out]
        with torch.no_grad():
            for dst, src in zip(self.t_out, self.ioc_out):
                dst.copy_(src)

    def _tail_fwd(self):
        out = dict(self.tail_in, refined_traj=self.t_out[0],
                   scores=self.t_out[1], per_iter_trajs=self.t_out[2:])
        self.total, metrics = desire.loss_tail(
            self.cfg, out, self.inputs["lane_u"], step=self.step)
        self.metric_names = list(metrics)
        self.metric_stack = torch.stack(
            [metrics[k].detach().reshape(()) for k in self.metric_names])

    def _tail_bwd(self):
        keys = [k for k in self.grad_keys if k in self.tail_in]
        got = torch.autograd.grad(
            self.total, [self.tail_in[k] for k in keys] + self.t_out,
            allow_unused=True)
        self.d_tail = dict(zip(keys, got))
        self.d_out = got[len(keys):]

    def _refine_bwd(self, leaves):
        pairs = [(o, g) for o, g in zip(self.ioc_out, self.d_out)
                 if g is not None]
        keys = [k for k in _IOC_GRAD if k in self.grad_keys]
        got = _vjp(pairs, [self.ioc_in[k] for k in keys] + leaves)
        self.ioc_out = None
        with torch.no_grad():
            for k, g in zip(keys, got):
                if g is None:
                    self._ioc_grad(k).zero_()
                else:
                    self._ioc_grad(k).copy_(g)
        return got[len(keys):]

    def _ioc_grad(self, k):
        """The buffer of the IOC's gradient of the encode's output ``k``:
        contiguous, as the IOC backward hands it over, whatever the
        output's strides."""
        if k not in self.g_ioc:
            x = self.enc[k]
            self.g_ioc[k] = torch.zeros(x.shape, dtype=x.dtype,
                                        device=x.device)
        return self.g_ioc[k]

    def _encode_bwd(self):
        pairs = []
        for k in self.grad_keys:
            parts = [g for g in (self.d_tail.get(k), self.g_ioc.get(k))
                     if g is not None]
            if parts:
                pairs.append((self.enc[k], parts[0] if len(parts) == 1
                              else parts[0] + parts[1]))
        got = _vjp(pairs, self.leaves)
        # contiguous, as the optimizer kernels take them
        self.enc_grads = [None if g is None else g.contiguous() for g in got]

    def _run(self, stage):
        if self.graphs is None:
            getattr(self, "_" + stage)()
            return
        self.graphs[stage].replay()
        if self.counts[stage]:
            telemetry.add_tally(self.counts[stage])

    # -- a step ----------------------------------------------------------

    @torch.no_grad()
    def _copy_in(self, state, params, xy, mask, ids, img, noise):
        if self.flat is None:
            # eager stages (the CPU): no graph holds the leaves' addresses
            self.leaves = tree_leaves(params)
        else:
            self.flat.copy_(state.flat.params)
        batch = {"xy": xy, "mask": mask, "ids": ids, "img": img}
        for k, dst in self.inputs.items():
            dst.copy_(batch[k] if k in batch else noise[k])
        self.step.fill_(float(state.step))

    def forward(self, state, params, xy, mask, ids, img, noise):
        """The loss of the batch at the params of ``state``, at its step:
        copy in, encode, the IOC on ``params`` (the step's tree of leaves
        that take gradients), the tail. Returns the metrics, one fresh
        copy."""
        self._copy_in(state, params, xy, mask, ids, img, noise)
        self._run("encode_fwd")
        self._refine_fwd(params)
        self._run("tail_fwd")
        values = self.metric_stack.clone()
        return dict(zip(self.metric_names, values.unbind(0)))

    def backward(self, leaves):
        """The gradients of the last ``forward``'s loss with respect to
        ``leaves`` (the step's leaves, ``tree_leaves`` order), contiguous;
        zeros for a leaf that no stage reads."""
        self._run("tail_bwd")
        ioc_grads = self._refine_bwd(leaves)
        self._run("encode_bwd")
        out = []
        for i, (x, e, o) in enumerate(zip(leaves, self.enc_grads,
                                          ioc_grads)):
            if o is not None:
                o = o.contiguous()
            if e is None and o is None:
                if i not in self.zeros:
                    self.zeros[i] = torch.zeros_like(x)
                out.append(self.zeros[i])
            else:
                out.append(o if e is None else e if o is None else e + o)
        return out

    def capture(self, state, params, xy, mask, ids, img, noise):
        """Warm up and capture the four graphs, from the first step's
        arguments (``forward``'s). A capture that fails raises."""
        dev = xy.device
        before = telemetry.tally()
        # the warm-up on the step's stream, whose cached memory later eager
        # work reuses
        self._copy_in(state, params, xy, mask, ids, img, noise)
        for _ in range(WARMUP):
            # the captured stages, eagerly; the IOC's forward gives the
            # tail its inputs, and its backward is left out (the encode's
            # gradients from it are zeros here)
            self._encode_fwd()
            self._refine_fwd(params)
            self._tail_fwd()
            self._tail_bwd()
            self.ioc_out = None
            for k in _IOC_GRAD:
                if k in self.grad_keys:
                    self._ioc_grad(k)
            self._encode_bwd()
        # the warm-up's autograd graphs go, and with them the static
        # leaves' gradient accumulators, made anew on the capture's stream
        self.enc = self.ioc_in = self.tail_in = self.total = None
        self.d_tail = self.d_out = self.enc_grads = None
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        pool = torch.cuda.graph_pool_handle()
        graphs = {}
        for stage in _STAGES:
            # capture_begin and capture_end, not torch.cuda.graph, which
            # empties the allocator's cache before each capture
            graphs[stage] = torch.cuda.CUDAGraph()
            start = telemetry.tally()
            with torch.cuda.stream(side):
                graphs[stage].capture_begin(pool=pool)
                try:
                    with _NoDraws():
                        getattr(self, "_" + stage)()
                finally:
                    graphs[stage].capture_end()
            end = telemetry.tally()
            self.counts[stage] = {k: end[k] - start.get(k, 0) for k in end
                                  if end[k] != start.get(k, 0)}
        # the warm-up's and the captures' counts are taken back
        now = telemetry.tally()
        telemetry.add_tally({k: before.get(k, 0) - v for k, v in now.items()
                             if v != before.get(k, 0)})
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graphs = graphs
