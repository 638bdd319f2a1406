"""Configuration system for the cascaded-inference framework.

A copy of the JAX package's ``repro/configs/base.py`` with every dataclass
and field unchanged, so a config built here compares equal, field by field,
with the reference's.  Docstrings that name ``repro.*`` modules describe the
reference implementation; the port's counterparts live under
``repro_torch.*`` with the same names.

Every assigned architecture is expressed as a :class:`ModelConfig`.  Configs are
frozen dataclasses so they are hashable and can key jit caches.  Each arch file
in this package exports ``CONFIG`` (the full, paper-cited configuration) and a
``reduced()`` smoke variant (2 layers, d_model<=512, <=4 experts) used by the
CPU tests.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Cascade (the paper's contribution) hyper-parameters.

    ``n_components`` is the paper's ``n_m``.  ``exit_boundaries`` are the layer
    indices *after which* an exit head branches (len == n_components - 1); the
    final component exits at the last layer implicitly.  ``enhance_dim``
    implements the paper's "classifier enhancement" (a widening projection in
    the intermediate heads; 0 disables).  ``thresholds`` is the live
    ``(δ̂_0 … δ̂_{n_m-1})`` vector — mutable at inference time *without
    retraining* (Goal 1.2); the last entry must be 0.
    """

    n_components: int = 3
    exit_boundaries: Tuple[int, ...] = ()
    enhance_dim: int = 0
    thresholds: Tuple[float, ...] = (0.9, 0.9, 0.0)
    # Strategy strings resolved through repro.core.policy's registries (kept
    # as strings so the config stays frozen/hashable and can key jit caches).
    # Measures: "softmax_max" | "entropy" | "margin" | "patience@k[:base]".
    confidence: str = "softmax_max"
    # Exit policies: "threshold" (Algorithm 1) | "budget@<avg-mac-target>"
    # (budget additionally needs a calibration-time policy.fit() with
    # held-out confidences before it can decide).
    policy: str = "threshold"
    # Threshold calibrators (§5): "self" (paper) | "final" (cascade-level).
    calibrator: str = "self"
    # How the staged executor (repro.core.exec) realizes the exit decision:
    #   "select"     — fixed graph: every segment computes, the skip
    #                  predicate selects results (dry-run/roofline shape);
    #   "cond_batch" — lax.cond per segment: once every live sequence has
    #                  exited, deeper segments' compute is skipped (only the
    #                  cheap cache backfill runs).
    # The two modes produce bit-identical tokens, exit indices and carried
    # DecodeState — exit_mode picks an execution strategy, never a semantics.
    exit_mode: str = "select"
    # Skip-predicate granularity for staged decode: the batch is split into
    # ``n_cohorts`` contiguous, equal-size cohorts, each with its OWN skip
    # predicate (nested lax.cond per cohort in cond_batch mode).  A segment's
    # compute is skipped for a cohort once every live sequence in THAT cohort
    # has exited, so mixed-difficulty batches realize more of the measured
    # skip opportunity than the whole-batch (n_cohorts=1) predicate.  Unlike
    # exit_mode this IS semantics: which rows get backfilled (vs computed)
    # cache entries depends on the cohort split, so compare runs at equal
    # n_cohorts.  Batches not divisible by n_cohorts degrade to the largest
    # divisor (1 in the worst case), mirroring the sharding rules.
    n_cohorts: int = 1
    # How cohort-split staged decode touches memory (perf only — the two
    # layouts are bit-identical; tested):
    #   "major" — cohort-major hot path: the batch axis of h / carry /
    #             cache is viewed as (cohort, B/C) (a zero-copy reshape —
    #             cohorts are contiguous batch ranges), the per-cohort
    #             split happens ONCE per step, and every deep segment
    #             dispatches on the lane's exit state (all-exited -> one
    #             whole-batch backfill; none-exited -> one whole-batch
    #             dense segment; mixed -> per-cohort lax.cond), so the
    #             slice/re-join machinery only runs when cohorts disagree.
    #   "copy"  — the legacy per-segment slice + concat path, kept as the
    #             ablation baseline for the layout benchmark.
    cohort_layout: str = "major"
    # Whether deeper-layer KV / recurrent state is backfilled from the exit
    # hidden state so later tokens can attend at full depth.
    state_backfill: bool = True
    # Share the final unembedding across exit heads (the LLM adaptation of the
    # paper's "negligible parameter addition": per-exit norm + low-rank
    # enhancement only; the vocab projection is shared).
    share_unembed: bool = True
    # Loss mode for train_step: "joint" (BranchyNet-style multi-loss baseline),
    # "backtrack" (the paper's Algorithm 2, phase-controlled), "last" (phase 0).
    loss_mode: str = "joint"
    # Per-exit loss weights in joint mode.
    joint_weights: Tuple[float, ...] = ()
    # Train intermediate exit heads on every k-th position only (§Perf H7):
    # the (B,S,vocab) intermediate logits dominate training HBM traffic for
    # large-vocab archs; the heads see plenty of signal at stride 4.
    exit_loss_stride: int = 1

    def __post_init__(self):
        if self.exit_mode not in ("select", "cond_batch"):
            raise ValueError(
                f"exit_mode must be 'select' or 'cond_batch', got "
                f"{self.exit_mode!r}")
        if self.n_cohorts < 1:
            raise ValueError(f"n_cohorts must be >= 1, got {self.n_cohorts}")
        if self.cohort_layout not in ("major", "copy"):
            raise ValueError(
                f"cohort_layout must be 'major' or 'copy', got "
                f"{self.cohort_layout!r}")


@dataclasses.dataclass(frozen=True)
class AutotuneConfig:
    """Online exit-telemetry + threshold-autotuning knobs (``repro.autotune``).

    With ``enabled``, every staged decode step accumulates a device-resident
    :class:`repro.autotune.telemetry.ExitTelemetry` pytree inside the carried
    ``DecodeState`` (per-component confidence histograms, exit counts, MAC
    counters, and a shadow-sampled joint histogram with a correctness proxy:
    does the exited prediction agree with the final component?).  The
    histograms are fixed-bin over the confidence range (0, 1]: ``bins``
    uniform bins, so a deployed threshold δ = e/bins corresponds exactly to
    the bin-edge gate ``bin >= e``.

    ``shadow_every`` picks the shadow full-depth sampling rate: every k-th
    decode step (by the lane's position cursor, so the schedule is
    deterministic and identical across host/device runtimes) OBSERVES the
    full depth — segments the skip predicate would drop compute their exit
    logits from a separate shadow hidden chain and record ALL components'
    confidences + agreement-with-final into the telemetry rider only,
    while the committed caches, decisions and patience streaks keep exact
    skip semantics.  Token streams are bit-identical with telemetry on or
    off (pinned by tests); the cost is ~1/k extra segment compute and the
    ``segments_run`` counters counting the observations.

    The remaining fields parameterize the :class:`ThresholdController`:
    ``resolve_every`` engine ticks between threshold resolutions,
    ``min_shadow`` shadow observations before the first solve, ``hysteresis``
    (minimum max-threshold movement worth pushing), and ``drift_tol``
    (L1 distance between consecutive windows' normalized joint SHADOW
    histograms — full-depth, threshold-independent evidence — beyond which
    the pre-drift accumulated history is excluded from this and all future
    resolves).
    ``epsilon`` / ``mac_budget`` pick the solve direction: a target accuracy
    degradation ε (paper §5, generalized to a joint search) or a target
    average-MAC budget (``mac_budget > 0`` wins when both are set).
    """

    enabled: bool = False
    bins: int = 32
    shadow_every: int = 16
    resolve_every: int = 64
    min_shadow: int = 256
    hysteresis: float = 0.02
    drift_tol: float = 0.25
    epsilon: float = 0.05
    mac_budget: float = 0.0
    # Add the FINAL component's confidence as an extra routing axis of the
    # shadow joint histogram.  Within one model the final component always
    # answers and its confidence never routes; in a cross-model escalation
    # tier (``repro.escalate``) answering at the final component is itself
    # a routed decision — defer to the next stage when its confidence is
    # below the escalation threshold — so the tier's joint solve needs the
    # final axis observed.  Costs bins× cells; leave False outside a tier.
    route_final: bool = False

    def __post_init__(self):
        if self.bins < 2:
            raise ValueError(f"autotune.bins must be >= 2, got {self.bins}")
        if self.shadow_every < 1:
            raise ValueError(
                f"autotune.shadow_every must be >= 1, got {self.shadow_every}")
        if self.resolve_every < 1:
            raise ValueError(
                f"autotune.resolve_every must be >= 1, got "
                f"{self.resolve_every}")


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """KV-cache layout knobs for the serving engine (``repro.serving.paged``).

    ``layout="dense"`` keeps the per-lane worst-case ``(B, cache_len)`` slab
    (the bit-identity ablation baseline).  ``layout="paged"`` replaces the
    slab's attention k/v leaves with shared block stores addressed through
    per-(component, slot) block tables carried in ``DecodeState``: blocks are
    allocated lazily as the ring cursor reaches them and return to the
    :class:`repro.serving.paged.BlockPool` the moment a slot finishes — for
    skipped deep components first — instead of at whole-lane re-prefill.

    ``block_size`` is the number of ring positions per block and must divide
    the engine's ``cache_len``.  ``num_blocks`` sizes the shared pool
    (``0`` = auto: the dense-equivalent block count plus the reserved trash
    block, i.e. the same bytes as the dense slabs).  Token/exit/confidence
    streams are bit-identical between the two layouts (pinned by
    ``tests/test_paged_cache.py``); layout is an execution strategy, never a
    semantics.
    """

    layout: str = "dense"
    block_size: int = 16
    num_blocks: int = 0

    def __post_init__(self):
        if self.layout not in ("dense", "paged"):
            raise ValueError(
                f"cache layout must be 'dense' or 'paged', got "
                f"{self.layout!r}")
        if self.block_size < 1:
            raise ValueError(
                f"paged_cache.block_size must be >= 1, got {self.block_size}")
        if self.num_blocks < 0:
            raise ValueError(
                f"paged_cache.num_blocks must be >= 0 (0 = auto), got "
                f"{self.num_blocks}")


@dataclasses.dataclass(frozen=True)
class EscalationConfig:
    """Cross-model escalation knobs for one stage of a
    :class:`repro.escalate.ModelCascadeTier`.

    The tier fronts an ordered pool of serving engines (small drafts,
    large verifies).  A request decodes on its current stage; every token
    that the intra-model cascade answers at the stage's FINAL component is
    additionally gated by ``threshold`` — an IDK-style answer-or-defer
    decision (Wang et al., 2017): when the final component's confidence is
    below it, the request is cancelled at that token and re-submitted to
    the next stage, replaying the already-committed prefix as prefill.

    ``threshold`` uses the engine's confidence conventions: 0.0 never
    defers (every final-component answer stands — the escalate-never
    parity corner), the sentinel 1.1 always defers.  ``confidence`` names
    the :class:`repro.core.policy.ConfidenceMeasure` registry entry the
    defer decision reads; it must match the stage's own
    ``cascade.confidence`` measure (the deferral reuses the confidence the
    decision scan already computed for the answering token — a different
    measure would need the logits, which the serving engine does not
    retain), or be left "" to inherit it.  ``share_prefix`` gates prefix
    replay into the next stage: ``None`` auto-detects (same vocab_size and
    family ⇒ the committed tokens are valid next-stage input), ``False``
    forces full regeneration from the original prompt.
    """

    enabled: bool = False
    threshold: float = 0.0
    confidence: str = ""
    share_prefix: Optional[bool] = None

    def __post_init__(self):
        if self.threshold < 0.0:
            raise ValueError(
                f"escalation.threshold must be >= 0, got {self.threshold}")


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Cross-engine fleet knobs (``repro.fleet``).

    A :class:`repro.fleet.FleetScheduler` fronts ``n_engines`` serving
    engines (or escalation tiers) and places each incoming request by a
    weighted score over three signals: the distance between the member's
    observed exit-depth EMA and the request's predicted depth
    (``depth_weight`` — the same DepthCompactor prior the engines use for
    lane assignment, lifted one level up), the member's occupancy
    (``load_weight`` — live slots plus queued requests over capacity),
    and, for paged members, block-pool pressure (``block_weight`` — the
    used fraction of the shared KV pool).  Weights are relative; zeroing
    one disables that signal.

    Health tracking probes each member's ``stats()`` every
    ``heartbeat_every`` scheduler ticks.  A failed probe backs off
    exponentially (``backoff_base ** consecutive_failures`` ticks,
    bounded by ``backoff_cap``) before re-probing; ``max_failures``
    consecutive failures mark the member unhealthy — excluded from
    placement, stepping and telemetry until a later probe succeeds.

    ``drain_mode`` picks the default :meth:`~repro.fleet.FleetScheduler.
    drain` semantics: ``"finish"`` lets in-flight slots run to exit or
    budget on the draining member while its queued requests requeue to
    siblings; ``"migrate"`` additionally cancels in-flight slots and
    replays their committed prefixes into siblings (the escalation replay path —
    zero committed tokens lost between prefix-compatible members).
    """

    n_engines: int = 1
    depth_weight: float = 1.0
    load_weight: float = 1.0
    block_weight: float = 0.5
    heartbeat_every: int = 4
    max_failures: int = 3
    backoff_base: int = 2
    backoff_cap: int = 64
    drain_mode: str = "finish"

    def __post_init__(self):
        if self.n_engines < 1:
            raise ValueError(
                f"fleet.n_engines must be >= 1, got {self.n_engines}")
        for knob in ("depth_weight", "load_weight", "block_weight"):
            if getattr(self, knob) < 0.0:
                raise ValueError(
                    f"fleet.{knob} must be >= 0, got {getattr(self, knob)}")
        if self.heartbeat_every < 1:
            raise ValueError(
                f"fleet.heartbeat_every must be >= 1, got "
                f"{self.heartbeat_every}")
        if self.max_failures < 1:
            raise ValueError(
                f"fleet.max_failures must be >= 1, got {self.max_failures}")
        if self.backoff_base < 1:
            raise ValueError(
                f"fleet.backoff_base must be >= 1, got {self.backoff_base}")
        if self.backoff_cap < 1:
            raise ValueError(
                f"fleet.backoff_cap must be >= 1, got {self.backoff_cap}")
        if self.drain_mode not in ("finish", "migrate"):
            raise ValueError(
                f"fleet.drain_mode must be 'finish' or 'migrate', got "
                f"{self.drain_mode!r}")


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability knobs (``repro.obs``): the cascade flight recorder.

    With ``enabled``, the serving engine assembles a structured span tree
    per request — submit → queue-wait → admit(lane, cohort, predicted
    depth) → prefill → per-chunk decode (tokens, exit components,
    confidence at exit) → exit | escalate | migrate → finalize — entirely
    host-side, from data the jitted programs already return at existing
    host-sync boundaries plus ``perf_counter`` stamps around them.  The
    device programs gain ZERO new host syncs and ZERO retraces: recording
    never touches a traced graph, so token/exit/confidence streams are
    bit-identical recorder-on vs recorder-off (pinned by
    ``tests/test_obs.py`` and gated ≥ 0.97 throughput ratio in
    ``BENCH_serving.json["obs"]``).

    ``max_flights`` bounds the ring buffer of COMPLETED flight records
    (live flights are bounded by slot capacity); the oldest record is
    evicted when the ring is full, so a long-running engine's postmortem
    memory stays O(max_flights).  ``max_events`` bounds the engine-level
    event log (threshold pushes, drains, chunk slices for the Perfetto
    timeline).  ``reservoir`` bounds the per-metric latency reservoirs
    the p50/p95/p99 summaries are computed from (newest-wins).
    """

    enabled: bool = False
    max_flights: int = 64
    max_events: int = 1024
    reservoir: int = 1024

    def __post_init__(self):
        if self.max_flights < 1:
            raise ValueError(
                f"obs.max_flights must be >= 1, got {self.max_flights}")
        if self.max_events < 1:
            raise ValueError(
                f"obs.max_events must be >= 1, got {self.max_events}")
        if self.reservoir < 1:
            raise ValueError(
                f"obs.reservoir must be >= 1, got {self.reservoir}")


@dataclasses.dataclass(frozen=True)
class KernelTuneConfig:
    """Pallas kernel tile autotuning + fusion knobs (``repro.kernels``).

    ``enabled`` sweeps each kernel's candidate tile shapes on
    representative shapes at engine build time (or loads a previously
    swept artifact — :mod:`repro.kernels.autotune`) and installs the
    winners into the process-wide tile registry every ``kernels/ops.py``
    wrapper consults.  Tile shapes are *static* kernel parameters, so an
    install that changes a tile triggers exactly one recompile of that
    kernel's inner jit at install time; installs that resolve to the same
    tiles are cache hits (no retrace — the serving loop's
    ``_cache_size() == 1`` contract holds because installation happens
    before the decode loop traces).

    ``artifact_dir`` persists the sweep result keyed by a config hash
    over (artifact version, platform, execution backend, sweep preset):
    a matching artifact skips the sweep entirely; a mismatched hash falls
    back to the defaults with a warning (never silently reuses stale
    tiles).  ``shapes`` picks the sweep preset (``"tiny"`` = CI-sized
    shapes, ``"serving"`` = the serving-bench shapes).

    ``megakernel`` routes the decode scan's exit-head evaluation through
    the fused per-segment megakernel (:mod:`repro.kernels.megakernel`):
    rmsnorm + shared-unembed matmul + softmax confidence + exit-update
    carry merge in ONE streaming pass over vocab tiles — the (B, V)
    logits never reach HBM.  Heads outside the fusion boundary
    (layernorm bias, enhancement MLP) transparently fall back to the
    unfused path.  ``cohort_scatter`` replaces the mixed-exit cohort
    re-join (per-cohort slice + ``concatenate``) with the aliased Pallas
    scatter kernel (:mod:`repro.kernels.cohort_cache`) that writes each
    cohort's cache rows in place.  Both default off: decode streams are
    pinned bit-identical either way, but flipping them changes the
    traced graph.
    """

    enabled: bool = False
    artifact_dir: Optional[str] = None
    shapes: str = "tiny"
    megakernel: bool = False
    cohort_scatter: bool = False

    def __post_init__(self):
        if self.shapes not in ("tiny", "serving"):
            raise ValueError(
                f"kernel_tune.shapes must be 'tiny' or 'serving', got "
                f"{self.shapes!r}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Units follow each model card exactly."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm | cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    source: str = ""   # paper / model-card citation

    # --- attention ---
    attn_window: int = 0          # 0 = full attention; >0 = sliding window
    # chunked-attention tile sizes (§Perf H8): KV is re-read once per query
    # chunk, so total attention HBM traffic ∝ S/attn_qchunk
    attn_qchunk: int = 512
    attn_kchunk: int = 1024
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    max_seq_len: int = 131072

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- xLSTM ---
    slstm_every: int = 0          # every k-th layer is sLSTM (0 = none)

    # --- hybrid (zamba2-style shared attention) ---
    shared_attn_every: int = 0    # a shared attention block every k SSM layers

    # --- VLM ---
    cross_attn_every: int = 0     # every k-th layer has cross-attention
    n_image_tokens: int = 0

    # --- audio (enc-dec) ---
    encoder_layers: int = 0
    n_audio_frames: int = 0       # encoder output frames (stub frontend)

    # --- numerics / misc ---
    dtype: str = "bfloat16"
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    act: str = "swiglu"           # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    use_kernels: bool = False     # route hot ops through Pallas kernels
    # Pallas execution backend override for this config's kernels: None =
    # auto (interpret only off-TPU; REPRO_KERNEL_INTERPRET env var wins),
    # True/False force the interpreter / compiled path.  See
    # repro.kernels.backend.resolve_interpret for the precedence order.
    kernel_interpret: Optional[bool] = None
    remat: bool = True            # activation-checkpoint each block in training
    # remat policy: "full" recomputes everything in backward (min memory,
    # max recompute bytes); "dots" saves matmul outputs and recomputes only
    # elementwise ops (§Perf H6 — trades temp memory for HBM traffic).
    remat_policy: str = "full"
    # Fully unroll the layer scans.  HLO size grows O(L) but XLA cost
    # analysis then counts every layer (scan bodies are otherwise counted
    # once) — used by the dry-run to extract exact roofline terms.
    scan_unroll: bool = False

    cascade: CascadeConfig = dataclasses.field(default_factory=CascadeConfig)
    autotune: AutotuneConfig = dataclasses.field(
        default_factory=AutotuneConfig)
    paged_cache: PagedCacheConfig = dataclasses.field(
        default_factory=PagedCacheConfig)
    escalation: EscalationConfig = dataclasses.field(
        default_factory=EscalationConfig)
    fleet: FleetConfig = dataclasses.field(default_factory=FleetConfig)
    kernel_tune: KernelTuneConfig = dataclasses.field(
        default_factory=KernelTuneConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def segments(self) -> Tuple[Tuple[int, int], ...]:
        """(start, end) layer ranges of the n_components backbone segments."""
        bounds = self.cascade.exit_boundaries or default_exit_boundaries(
            self.n_layers, self.cascade.n_components)
        out, prev = [], 0
        for b in bounds:
            out.append((prev, b))
            prev = b
        out.append((prev, self.n_layers))
        return tuple(out)

    def with_cascade(self, **kw) -> "ModelConfig":
        return dataclasses.replace(
            self, cascade=dataclasses.replace(self.cascade, **kw))

    def with_autotune(self, **kw) -> "ModelConfig":
        return dataclasses.replace(
            self, autotune=dataclasses.replace(self.autotune, **kw))

    def with_paged_cache(self, **kw) -> "ModelConfig":
        return dataclasses.replace(
            self, paged_cache=dataclasses.replace(self.paged_cache, **kw))

    def with_escalation(self, **kw) -> "ModelConfig":
        return dataclasses.replace(
            self, escalation=dataclasses.replace(self.escalation, **kw))

    def with_fleet(self, **kw) -> "ModelConfig":
        return dataclasses.replace(
            self, fleet=dataclasses.replace(self.fleet, **kw))

    def with_kernel_tune(self, **kw) -> "ModelConfig":
        return dataclasses.replace(
            self, kernel_tune=dataclasses.replace(self.kernel_tune, **kw))

    def with_obs(self, **kw) -> "ModelConfig":
        if not kw:
            kw = {"enabled": True}
        return dataclasses.replace(
            self, obs=dataclasses.replace(self.obs, **kw))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def default_exit_boundaries(n_layers: int, n_components: int) -> Tuple[int, ...]:
    """Split ``n_layers`` into ``n_components`` near-equal segments.

    Returns the n_components-1 interior boundaries.  Exits branch *after*
    these layer indices.
    """
    if n_components < 2:
        return ()
    step = n_layers / n_components
    return tuple(max(1, round(step * (i + 1))) for i in range(n_components - 1))


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned (seq_len, global_batch) workload."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant of a config: 2 layers, d_model<=512, <=4 experts."""
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    # keep the GQA ratio if possible
    if cfg.n_kv_heads < cfg.n_heads:
        n_kv = max(1, n_heads // max(1, cfg.q_per_kv))
    kw = dict(
        n_layers=2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=0,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        max_seq_len=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32,
        ssm_chunk=32,
        n_image_tokens=min(cfg.n_image_tokens, 16) if cfg.n_image_tokens else 0,
        encoder_layers=min(cfg.encoder_layers, 2) if cfg.encoder_layers else 0,
        n_audio_frames=min(cfg.n_audio_frames, 30) if cfg.n_audio_frames else 0,
        cross_attn_every=2 if cfg.cross_attn_every else 0,
        shared_attn_every=2 if cfg.shared_attn_every else 0,
        slstm_every=2 if cfg.slstm_every else 0,
        attn_window=min(cfg.attn_window, 128) if cfg.attn_window else 0,
        dtype="float32",
        cascade=dataclasses.replace(cfg.cascade, exit_boundaries=(1,),
                                    n_components=2,
                                    thresholds=(0.9, 0.0)),
    )
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)


_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    """Look up a registered architecture by ``--arch`` id."""
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    # import for registration side effect; the port has the dense family
    # (qwen2.5-3b, yi-9b, deepseek-coder-33b, minitron-4b), the moe family
    # (mixtral-8x7b, qwen3-moe-235b-a22b), the hybrid family (zamba2-1.2b),
    # the ssm family (xlstm-350m), the audio family (whisper-tiny), the vlm
    # family (llama-3.2-vision-90b) and the paper's ci-resnet18
    from repro_torch.configs import (  # noqa: F401
        ci_resnet18, deepseek_coder_33b, llama_3p2_vision_90b, minitron_4b,
        mixtral_8x7b, qwen2p5_3b, qwen3_moe_235b_a22b, whisper_tiny,
        xlstm_350m, yi_9b, zamba2_1p2b)
