"""Typed configuration of the PyTorch port: its own copy of
``desire_tpu/config.py`` (standard library only), field for field, with the
same defaults, validation, JSON form and absent-key backfill, so that a
config saved by either package loads in the other. The port imports nothing
of the JAX package; tests/test_torch_config.py holds the two copies equal.

Flag names and defaults mirror the reference CLI (``train.py:30-88`` of the
original implementation) for drop-in continuity; everything the reference
hardcoded (K=7 at ``model/model.py:280``, channel_multiplier=100 at
``model/model.py:46``, the obs/pred split, the 2.5 Hz subsample rate) is
promoted to a real flag here.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any


@dataclasses.dataclass
class DesireConfig:
    # ---- reference-compatible flags (train.py:30-88) ----
    rnn_size: int = 512          # sizes the VAE input: vae_input = (sqrt(2*rnn_size))**2
    num_layers: int = 1          # GRU stack depth
    model: str = "gru"           # 'gru' only (reference never implemented others)
    batch_size: int = 10
    seq_length: int = 8          # compat-protocol window (reference train.py:43-44)
    num_epochs: int = 100
    save_every: int = 400
    grad_clip: float = 10.0
    learning_rate: float = 1e-3  # reference default was 0.005 (train.py:55-56);
    #                              1e-3 is the measured-stable recipe for this
    #                              model (RESULTS.md headline run)
    decay_rate: float = 0.985    # per-epoch exponential LR decay
    #                              (train.py:122-126; reference default 0.95
    #                              decays 190-step epochs too fast here)
    keep_prob: float = 0.8       # dropout keep prob (reference declared it, never used)
    embedding_size: int = 64     # spatial embedding before the encoders
    neighborhood_size: int = 32  # social-pooling neighborhood (pixels, normalized units)
    grid_size: int = 4           # social grid resolution
    max_num_obj: int = 60        # agent slots per sequence (id==0 -> empty slot)
    leave_dataset: int = 5       # held-out dataset index (reference train.py:77-78)
    latent_size: int = 128       # CVAE latent dim (train.py:80-81)
    e_dim: int = 256             # encoder fusion dim (reference declared, unused there)
    d_dim: int = 48              # GRU hidden size. Reference default was 16
    #                              (train.py:85-86); the DESIRE paper uses 48.
    stride: int = 1              # temporal-conv stride (train.py:87-88)

    # ---- promoted from hardcoded reference constants ----
    num_samples: int = 20        # K hypothesis lanes at TRAIN time (reference
    #                              hardcodes 7, model.py:280; eval draws its
    #                              own K). 20 is the round-3 unified recipe:
    #                              more train lanes buy ranking/calibration
    #                              quality (measured round 2: K=50-trained had
    #                              the best ranked-pick percentile and PIT),
    #                              while variety_k keeps the best-of-K oracle
    #                              gradient as concentrated as K=12 training.
    variety_k: int = 12          # min-aggregated (variety) losses take the
    #                              min over a RANDOM variety_k-lane subset per
    #                              agent per step instead of all K lanes
    #                              (0 = all lanes). Decouples "how many lanes
    #                              the ranker trains on" (num_samples) from
    #                              "how concentrated the best-of-K gradient
    #                              is": min over many lanes means the winner
    #                              rotates and each lane's head sees little
    #                              pull (measured round 2: K=50-trained oracle
    #                              15.74 px vs K=12-trained 14.84 px @K=50)
    channel_multiplier: int = 100  # temporal-conv feature multiplier (model.py:46)

    # ---- paper-protocol data flags (absent from the reference; see SURVEY §5) ----
    protocol: str = "paper"      # 'paper' (2.5 Hz, obs/pred split) | 'compat' (1-frame shift)
    obs_len: int = 8             # observed steps (3.2 s at 2.5 Hz)
    pred_len: int = 12           # predicted steps (4.8 s at 2.5 Hz)
    subsample: int = 12          # frame stride: SDD is ~30 fps -> 2.5 Hz
    normalize: bool = True       # per-scene [0,1] coordinate normalization
    window_hop: int = 2          # sampled-step stride between training windows
    scenes: str = ""             # comma-separated scene filter ('' = all)
    eval_scenes: str = ""        # held-out scenes for eval ('' = use the
    #                              `holdout` video split); generalizes the
    #                              reference's leave_dataset holdout intent
    holdout: str = "video"       # train/test separation (the reference's
    #                              leave_dataset intent, train.py:77-78):
    #                              'video' holds out the lexicographically
    #                              LAST video of every scene that has >= 2
    #                              videos — training never sees it, eval
    #                              defaults to it; 'none' = no split (eval
    #                              runs in-sample, pre-round-3 behavior)
    eval_hop: int = 4            # window hop for held-out eval loaders —
    #                              wider than the training hop so eval
    #                              windows overlap less (hop-2 agent-windows
    #                              are heavily correlated; n is reported)

    # ---- DESIRE modules missing from the reference (north star) ----
    use_ioc: bool = True         # IOC ranking & refinement module
    num_refine: int = 4          # refinement iterations (BASELINE.json config 3)
    use_scf: bool = True         # scene-context fusion (occupancy-grid scene CNN + pooling)
    scene_grid: int = 32         # scene feature grid resolution
    scene_channels: int = 32     # scene feature channels
    scene_image_channels: int = 0  # optional per-scene imagery channels
    #                              concatenated into the occupancy raster
    #                              (models/scf.py: the paper's scene CNN
    #                              pools camera-image features; with
    #                              channels > 0 the loader attaches a
    #                              per-video (G, G, Ci) raster to every
    #                              batch — see scene_image_source — and the
    #                              scene CNN consumes occupancy + imagery)
    scene_image_source: str = "occupancy"  # where the per-video raster comes
    #                              from when scene_image_channels > 0:
    #                              'occupancy' = a long-term occupancy prior
    #                              aggregated over ALL of the video's
    #                              records (log1p-normalized; the static
    #                              "walkability layout" role the paper's
    #                              camera frame plays — the checked-in SDD
    #                              layout ships no imagery). Caveat: the
    #                              aggregate includes every window's future
    #                              steps (~1e-4 of the mass each), so it is
    #                              a scene-level prior, not a per-window
    #                              oracle. Any other value = a directory
    #                              holding <scene>/<video>/reference.{jpg,
    #                              png,npy} camera frames, resampled onto
    #                              the isotropic [0,1]^2 annotation frame
    #                              (1 channel = grayscale, 3 = RGB)
    use_social: bool = True      # social (neighbor) pooling inside SCF

    # ---- loss weights ----
    w_nll: float = 1.0           # bivariate-Gaussian reconstruction NLL
    w_kld: float = 2.0           # CVAE KL divergence (headline recipe; 1.0
    #                              under-regularized the posterior at K=12)
    w_prior_nll: float = 0.5     # prior-predictive coverage: best-of-the-
    #                              prior-lanes NLL (min over the first
    #                              round(K*prior_lane_frac) lanes only) —
    #                              the train-time mirror of the INFERENCE
    #                              objective, where every lane is a prior
    #                              draw. The variety min-NLL almost never
    #                              selects a prior lane (posterior lanes are
    #                              future-conditioned and win the min) and
    #                              the IOC CE stop-gradients trajectories, so
    #                              without this term the prior head and the
    #                              z_temp_learn temperature head receive
    #                              almost no training signal. 0 = off;
    #                              needs prior_lane_frac > 0 to do anything.
    #                              DEFAULT 0.5 since round 4: the 40-epoch
    #                              A/B (RESULTS r4 ztemp triage) beat the
    #                              same-epoch control on every axis
    w_ce: float = 1.0            # IOC ranking cross-entropy
    w_reg: float = 1.0           # refinement regression
    w_delta: float = 0.5         # trust-region penalty on refinement deltas
    #                              (|refined - sgm|^2): with min-agg
    #                              regression only the winning lane gets a
    #                              direct pull, this keeps the other lanes'
    #                              deltas from drifting off their hypotheses.
    #                              Evidence at 0.1 (held-out nexus run):
    #                              SGM oracle 20.7px but refined 48.8px —
    #                              deltas still drifted ~60px on non-winning
    #                              lanes
    kld_warmup: int = 200        # steps of linear KLD annealing (0 = off)
    vel_scale: float = 0.25      # per-step displacement bound (scene units):
    #                              decoder velocities are tanh-squashed to
    #                              +-vel_scale, keeping hypotheses physical
    #                              even for out-of-distribution prior draws
    speed_norm: bool = True      # speed-adaptive residual bound: replaces the
    #                              fixed vel_scale bound with
    #                              vel_gain*observed_speed + vel_floor per
    #                              agent, so the same head weights express
    #                              walker-scale (~1.5 px/step) and bike-scale
    #                              (~25 px/step) corrections. Motivated by the
    #                              round-2 speed-class analysis: fast agents
    #                              (>=20 px/step) carried 4-5x the error of
    #                              slow ones on the bike-heavy scenes. Default
    #                              ON since round 3 — the round-2 headline
    #                              recipe used it (defaults now match the
    #                              documented recipe, VERDICT r2 item 5)
    vel_gain: float = 2.0        # bound = vel_gain * speed + vel_floor ...
    vel_floor: float = 0.004     # ... (scene units/step); floor lets near-
    #                              stationary agents still accelerate
    learn_bound: bool = True     # make vel_gain/vel_floor LEARNED scalars
    #                              (initialized at the config values): training
    #                              calibrates the residual envelope instead of
    #                              trusting the hand-picked 2.0/0.004
    aniso_bound: bool = False    # anisotropic residual bound: decode the
    #                              tanh residuals in the agent's observed
    #                              HEADING frame with separate learned
    #                              along-/cross-track gains (requires
    #                              speed_norm+learn_bound). Motivated by the
    #                              round-3 track decomposition: bike error is
    #                              2-4x ALONG-track, so the envelope should
    #                              be able to widen along the direction of
    #                              motion without adding lateral spread
    input_norm: bool = True      # scale-free trajectory encoding: divide the
    #                              ENCODER-side relative coordinates by the
    #                              agent's observed speed (stop-gradient) and
    #                              append log-speed as an input feature, so a
    #                              bike and a walker tracing the same shape
    #                              present identical inputs and the GRU/embed
    #                              weights are shared across speed classes
    #                              (the round-2/3 fast-agent gap: >=20px/step
    #                              agents carried ~3x the walker error).
    #                              Geometry (origin, CV composition, NLL
    #                              targets, IOC/SCF) stays absolute; the
    #                              speed-adaptive bound already rescales the
    #                              decoder output side. Default ON since the
    #                              round-3 triage: at 40 epochs held-out it
    #                              beat the control on EVERY metric (minADE
    #                              18.57 -> 16.91, top-1 36.6 -> 30.0,
    #                              [2,8) 28.0 -> 22.4; RESULTS triage table)
    speed_loss_alpha: float = 0.5  # class-balance exponent: per-agent loss
    #                              weight (speed / batch-mean-speed)^alpha
    #                              (re-normalized to mean 1 over live
    #                              agents). Fast agents are ~13% of SDD
    #                              windows; alpha>0 stops walkers from
    #                              dominating the gradient. 0 = off.
    #                              Default 0.5 from the round-3 triage:
    #                              alpha=1 ALONE hurt every class, but 0.5
    #                              on top of input_norm beat input_norm
    #                              alone (held-out minADE 16.91 -> 16.18,
    #                              bikes+ 41.4 -> 38.1; RESULTS triage
    #                              table) — balancing works once the
    #                              representation is scale-free
    social_freeze: bool = False  # compute the IOC social-attention pools
    #                              ONCE from the initial (SGM) positions and
    #                              reuse them across all refinement passes,
    #                              instead of re-attending at the refined
    #                              positions each pass (deltas are tanh-
    #                              bounded, so the distance-kernel weights
    #                              barely move). DECIDED round 4 (held-out
    #                              40-epoch freeze-trained triage): oracle
    #                              minADE 16.63 vs 16.18 control but top-1
    #                              27.35 vs 32.20 and rank-corr 0.35 vs
    #                              0.28 — the pace_lanes trade. fwd speed
    #                              is neutral post-VMEM-clamp (61.6 vs
    #                              60.1 ms; the freeze operands force a
    #                              256-row chunk). Stays a ranking-first
    #                              OPT-IN, not the default.
    speed_aug: float = 0.0       # train-time global window-zoom augmentation
    #                              (trainer.py step_fn): per window, scale all
    #                              agents around the scene center by
    #                              exp(U(-a, a)) — widens the speed range the
    #                              decoder/NLL see per trajectory shape
    #                              without breaking inter-agent geometry.
    #                              0 = off (opt-in triage lever).
    pace_range: float = 0.0      # per-lane along-track pace spread: a
    #                              zero-init head on each lane's first decode
    #                              hidden scales that lane's constant-velocity
    #                              base by 1 + pace_range*tanh(.), letting
    #                              hypotheses explicitly brake/accelerate.
    #                              Motivated by the track decomposition
    #                              (eval/metrics.py): fast-agent error is
    #                              2-4x ALONG-track — the lane set
    #                              under-covers speed profiles, not
    #                              directions. 0 = off (exact pre-flag
    #                              behavior: the head init is zero)
    pace_lanes: int = 0          # restrict the pace head to the LAST n
    #                              hypothesis lanes (0 = all lanes, the
    #                              original pace_range behavior). Round-3
    #                              triage: full-lane pace improved bikes+
    #                              and top-1 but cost ~1 px of oracle minADE
    #                              (it spreads walker lanes too); a subset
    #                              leaves K-n lanes untouched, bounding the
    #                              oracle cost while keeping along-track
    #                              coverage for fast agents
    z_temp_learn: bool = True    # learned speed-conditioned latent
    #                              temperature (VERDICT r3 item 5): a tiny
    #                              zero-init MLP on the stop-gradient observed
    #                              log-speed scales the latent noise on
    #                              PRIOR-drawn lanes (z = mu_p + sigma_p *
    #                              temp * eps) — train-time prior lanes (needs
    #                              prior_lane_frac > 0 for any gradient) and
    #                              every inference lane. Promotes the
    #                              eval-only --z_temp_fast knob (hard 20 px/
    #                              step threshold, hand-tuned scalar) into a
    #                              trained smooth speed->spread map; the
    #                              variety min-NLL + IOC CE supply the
    #                              coverage gradient, so fast agents can buy
    #                              along-track diversity while slow agents
    #                              can SHRINK spread (the held-out 50%
    #                              coverage is over-dispersed). Zero-init =
    #                              temp exactly 1 (pre-flag behavior) at init.
    #                              DEFAULT since round 4: +temp head beat the
    #                              no-head control 14.70 vs 15.23 px minADE@20
    #                              held-out at 40 epochs (top-1 24.4 vs 27.2)
    cond_prior: bool = True      # conditional CVAE prior p(z|X): a zero-init
    #                              head on the past encoding emits
    #                              (mu_p, logvar_p); KLD pulls the posterior
    #                              toward THIS prior and inference draws
    #                              z ~ p(z|X) instead of N(0, I). The paper's
    #                              standard-normal prior makes prior draws
    #                              blind to the agent (a bike and a standing
    #                              pedestrian share one hypothesis
    #                              distribution) — the round-2 fast-agent gap.
    #                              Zero-init = starts exactly at N(0, I)
    prior_lane_frac: float = 0.3  # fraction of TRAIN-time hypothesis lanes
    #                              drawn from the (conditional) prior instead
    #                              of the posterior. Posterior draws cluster
    #                              around the observed future, so the IOC
    #                              ranker never sees the diverse lanes it
    #                              must discriminate at inference; prior
    #                              lanes close that train/test gap and give
    #                              the best-of-K NLL a direct prior-
    #                              predictive term. 0 = round-2 behavior.
    #                              DEFAULT 0.3 since round 4 (ztemp triage:
    #                              14.70 px minADE@20 / rank-corr 0.52 vs the
    #                              16.18 / 0.28 posterior-only flagship)
    vae_dec: str = "mlp"         # latent -> mask decoder: 'mlp' (default) or
    #                              'conv' (the reference's 4-deconv stack,
    #                              model/model.py:453-469). The deconv path
    #                              decodes every (agent, lane) through a fake
    #                              32x32 'image' only to collapse it to d mask
    #                              logits — ~50x the FLOPs and ~all of the SGM
    #                              stage's HBM bytes at K=20 (31 of 87.7 ms,
    #                              RESULTS r2 roofline) for a tensor nothing
    #                              consumes spatially. 'conv' is kept for
    #                              reference-geometry parity runs
    recon_agg: str = "min"       # NLL aggregation over K lanes: 'min' =
    #                              best-of-K / variety loss (optimizes the
    #                              minADE metric and resists lane collapse);
    #                              'mean' = every lane to GT (paper CVAE)
    kld_free_bits: float = 0.1   # per-dim KL floor (0 = off); keeps the
    #                              latent informative (anti posterior-collapse)
    rank_blend_fit: float = -1.0  # score/typicality blend weight FITTED on
    #                              a train-split slice at the end of training
    #                              (train.py _final_best_selection; VERDICT
    #                              r4 item 2: make --rank_blend a trained
    #                              quantity). -1 = unset. evaluate.py and
    #                              serve.Predictor use it for the top-1 pick
    #                              whenever no explicit --rank_blend is given
    #                              — the headline top-1 needs no eval flag.
    ioc_temp: float = 0.5        # IOC CE target-distribution temperature, in
    #                              units of the per-agent lane-distance SPREAD
    #                              (distances are z-scored across the K lanes
    #                              before the softmax — scale-free). Raw-unit
    #                              temperatures were a trap: 0.05 absolute
    #                              made the target uniform once lane spreads
    #                              shrank below ~0.05 units, and the train CE
    #                              pinned at ln(K) with top-1 at chance
    #                              (measured, round 2, 30 epochs)

    # ---- TPU execution ----
    compute_dtype: str = "bfloat16"  # activations dtype; params/optimizer stay fp32
    use_pallas: bool = True          # fused Pallas kernels on TPU (pure-XLA fallback off-TPU)
    fused_train: bool = True     # TRAIN with the fused IOC kernels: Pallas
    #                              forward (ops/ioc_fused.py) + full Pallas
    #                              backward (ops/ioc_bwd.py — in-kernel
    #                              recompute + reverse accumulation; NOT an
    #                              XLA replay). Gradient-parity tested vs
    #                              the XLA path. Measured (v5e, B=64 A=60
    #                              K=20, r3): 355 ms/step XLA, 409 ms/step
    #                              for a fused-fwd + XLA-recompute-bwd
    #                              hybrid (rejected), 275 ms/step for the
    #                              full Pallas fwd+bwd even while sharing
    #                              the chip with a training run. Under a
    #                              mesh the trainable pair runs per-shard
    #                              via shard_map with param-grad psums
    #                              (ops/ioc_fused.py
    #                              make_trainable_fused_ioc_sharded);
    #                              requires B % mesh_data == 0 and
    #                              K % mesh_k == 0, else the XLA path runs
    remat: bool = False          # jax.checkpoint the lane-parallel memory
    #                              hogs — each IOC iteration (its (B,K*T,A,A)
    #                              social-attention activations) and the
    #                              per-lane VAE mask decoder (its (B*A*K,
    #                              32,32,C) deconv maps) — recomputing them
    #                              in the backward pass instead of stashing.
    #                              Required for K=50 training (BASELINE
    #                              config 5): without it the train step
    #                              needs 20+ GB HBM temp at B=32 (measured
    #                              via XLA memory_analysis) vs the chip's 16
    mesh_data: int = 1               # data-parallel mesh axis size
    mesh_k: int = 1                  # hypothesis-lane mesh axis size
    seed: int = 0

    # ---- paths ----
    data_dir: str = "data/"
    save_dir: str = "save/"

    def __post_init__(self):
        if self.model != "gru":
            raise ValueError(f"only 'gru' is implemented (got {self.model!r})")
        if self.holdout not in ("none", "video"):
            raise ValueError(f"holdout must be 'none'|'video' (got {self.holdout!r})")
        if self.vae_dec not in ("mlp", "conv"):
            raise ValueError(f"vae_dec must be 'mlp'|'conv' (got {self.vae_dec!r})")
        side = int(math.isqrt(2 * self.rnn_size))
        if side * side != 2 * self.rnn_size:
            raise ValueError(
                f"2*rnn_size must be a perfect square (vae grid side); got rnn_size={self.rnn_size}"
            )

    # VAE input geometry mirrors reference model/model.py:57-59.
    @property
    def vae_side(self) -> int:
        return int(math.isqrt(2 * self.rnn_size))

    @property
    def vae_input_size(self) -> int:
        return self.vae_side * self.vae_side

    @property
    def total_len(self) -> int:
        if self.protocol == "paper":
            return self.obs_len + self.pred_len
        return self.seq_length + 1  # compat: targets are the 1-frame-shifted window

    def replace(self, **kw: Any) -> "DesireConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "DesireConfig":
        """Deserialize a saved config, preserving save-time behavior.

        to_json() writes EVERY field, so a key absent from a saved
        config.json means the field did not exist when the checkpoint
        was written — the feature itself postdates the checkpoint. Such
        keys must resolve to the pre-feature behavior (feature OFF),
        not to today's dataclass default: several of these flags add
        parameters (z_temp_learn: ztemp_fc1/fc2; cond_prior: the prior
        net; learn_bound: bound scalars) or change activation shapes
        (input_norm changes the embed width), so backfilling them with
        a later-flipped default makes the orbax restore template
        disagree with the saved tree and breaks restore/eval/resume of
        every older checkpoint.
        """
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        vals = {k: v for k, v in d.items() if k in known}
        for k, legacy in _PRE_FEATURE_DEFAULTS.items():
            if k not in d:
                vals[k] = legacy
        return cls(**vals)


# Fields added after round 1 whose current dataclass default differs from
# the pre-feature behavior. DesireConfig.from_json resolves keys ABSENT
# from a saved config.json to these values (the checkpoint predates the
# feature), so restoring/evaluating/resuming old checkpoints keeps their
# save-time semantics even after a default flip.
_PRE_FEATURE_DEFAULTS = {
    "z_temp_learn": False,   # learned speed->temp head (adds ztemp_fc1/fc2)
    "cond_prior": False,     # conditional prior net (adds params)
    "learn_bound": False,    # learned vel_gain/vel_floor scalars (adds params)
    "input_norm": False,     # scale-free encoding (changes embed width)
    "speed_norm": False,     # speed-adaptive residual bound (changes decode math)
    # the prior lanes and their NLL term: a config.json written before them
    # trained with every lane on the posterior and no prior-lane loss
    "prior_lane_frac": 0.0,
    "w_prior_nll": 0.0,
}


def add_config_flags(parser, defaults: DesireConfig | None = None) -> None:
    """Register every config field as an argparse flag (reference-name compatible)."""
    defaults = defaults or DesireConfig()
    for f in dataclasses.fields(DesireConfig):
        val = getattr(defaults, f.name)
        if isinstance(val, bool):
            parser.add_argument(f"--{f.name}", type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=val, help=f"(default: {val})")
        else:
            parser.add_argument(f"--{f.name}", type=type(val), default=val,
                                help=f"(default: {val})")


def config_from_args(args) -> DesireConfig:
    known = {f.name for f in dataclasses.fields(DesireConfig)}
    return DesireConfig(**{k: v for k, v in vars(args).items() if k in known})
