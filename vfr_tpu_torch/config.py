"""Frozen dataclass configs + the experiment presets (the PyTorch port's copy).

Field for field the same classes, order and defaults as the JAX package's
``config.py``: ``eval.corpus.index_fingerprint`` hashes ``repr(model.cfg)``,
so identical reprs give identical index fingerprints across the two packages.

The presets mirror BASELINE.json ``configs`` (lines 6-12):

1. ``didemo_rgb``      — DiDeMo, RGB-only, 21 proposals, triplet ranking
                         (CPU-runnable).
2. ``didemo_fusion``   — two-stream RGB + optical flow with TEF concat.
3. ``charades_sta``    — Charades-STA multi-scale sliding-window proposals.
4. ``corpus_didemo``   — corpus-level retrieval: inter-video negatives with
                         the full query x corpus similarity matrix sharded
                         over ICI.
5. ``serving_10k``     — large-scale serving: cached moment-embedding index,
                         batched top-k over a 10k-video corpus.

Every modeling choice the MCN family leaves ambiguous (distance sign, pooling
variant, GT aggregation) is an explicit flag so a later session can flip it
for parity against the real reference if it ever materializes (SURVEY.md §7).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "didemo"           # "didemo" | "charades_sta" | "synthetic"
    data_dir: str = "data/didemo"
    # DiDeMo clip structure: <=30 s video -> 6 clips of 5 s.
    num_clips: int = 6
    clip_seconds: float = 5.0
    # Charades-STA sliding windows: window lengths (seconds) and stride ratio.
    window_scales: Tuple[float, ...] = (12.0, 18.0, 24.0)
    window_stride_ratio: float = 0.25   # stride = ratio * window length
    max_windows: int = 64               # pad/mask budget for variable counts
    max_duration: float = 40.0          # Charades clip-feature grid horizon
    feature_seconds: float = 1.0        # Charades: one feature row per second
    # Query tokenization.
    max_query_len: int = 24
    glove_dim: int = 300
    vocab_size: int = 8192              # cap; real vocab built from data
    # Feature streams.
    feature_dim: int = 2048             # ResNet-152 pool5
    use_flow: bool = False
    # Device-resident feature-bank storage dtype ("float32" | "bfloat16").
    # bf16 halves the one-time bank H2D upload — the dominant cold-start
    # cost at spec scale (1.97 GB at ~10 MB/s relay, DESIGN 18) — and
    # halves bank HBM.  Features upcast to the model compute dtype at
    # gather time; only the stored inputs are quantized (validated at 10k
    # videos: corpus/localization metrics within seed jitter, DESIGN 20).
    bank_dtype: str = "float32"
    # Synthetic fixture (no real data in this environment).
    synthetic_num_videos: int = 64
    synthetic_num_queries: int = 256
    synthetic_seed: int = 0
    synthetic_noise: float = 0.1
    # Charades fixture: planted content spans per video.  >1 gives
    # localization intra-video distractors (a single planted moment makes
    # window ranking saturate — see data/synthetic.py).
    synthetic_moments_per_video: int = 1
    # fixture vocabulary size.  Counterintuitively, RAISING it hurt on the
    # quality fixture (2000 words -> each word seen ~8x in 2048 queries,
    # too sparse to learn compositions: corpus video-R@5 0.105 vs 0.139 at
    # the 200 default) — keep 200 unless the query count scales with it.
    synthetic_vocab_words: int = 200


@dataclass(frozen=True)
class ModelConfig:
    joint_dim: int = 128                # joint embedding dim (lane-aligned)
    rnn_cell: str = "lstm"              # "lstm" | "gru" query recurrence
    lstm_hidden: int = 1024             # query LSTM/GRU hidden size
    lstm_layers: int = 1
    query_dropout: float = 0.0
    use_tef: bool = True                # temporal endpoint features concat
    use_global_context: bool = True     # global mean-pool branch in moments
    per_stream_query_proj: bool = False  # separate query FC per stream (MCN
                                         # trains RGB/flow towers separately)
    pooling: str = "mean"               # "mean" | "max" segment pooling
    # Query sentence representation: "last" = the LSTM's final hidden
    # state (MCN-lineage default); "mean" = length-masked mean over ALL
    # hidden states (standard sentence-embedding pooling — every trunk
    # variant already returns hs [B, T, H] and the fused custom-VJPs
    # carry the d(hs) cotangent, so this is one masked reduction).
    query_pool: str = "last"            # "last" | "mean" | "attn"
    distance: str = "sqeuclidean"       # "sqeuclidean" | "euclidean" | "cosine"
    stream_weights: Tuple[float, ...] = (1.0,)   # per-stream distance fusion
    normalize_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"      # "bfloat16" on TPU for MXU speed
    use_pallas: str = "auto"            # "auto" | "always" | "never"
    moment_impl: str = "factored"       # "factored" (TPU-first) | "direct"
    # Training-path LSTM implementation: "fused" = custom-VJP layout (input
    # GEMM hoisted out of the scan; every weight gradient one sequence-sized
    # GEMM — see ops/lstm.py::lstm_forward_fused); "scan" = plain lax.scan
    # autodiff.  Gradient-parity-tested interchangeable
    # (tests/test_lstm_fused.py); default follows the step-time measurement
    # in docs/DESIGN.md.
    train_rnn_impl: str = "fused"


@dataclass(frozen=True)
class DecoderConfig:
    """A Nemotron-H decoder LM as a query tower, by the keys of its
    published ``config.json`` (defaults: NVIDIA-Nemotron-3-Nano-30B-A3B,
    https://huggingface.co/nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16).
    ``hybrid_override_pattern`` gives each block's mixer: M Mamba-2, E a
    mixture of experts, * attention.  Keys that shape no inference step
    (initialisation, RoPE, which no mixer of the published code applies,
    the LM head, which an embedder drops) are kept so that the
    configuration reads as published; ``models/nemotron_h.py::check``
    refuses values whose mathematics the port does not implement."""
    attention_bias: bool = False
    chunk_size: int = 128
    conv_kernel: int = 4
    expand: int = 2
    head_dim: int = 128
    hidden_size: int = 2688
    hybrid_override_pattern: str = (
        "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME")
    intermediate_size: int = 1856
    layer_norm_epsilon: float = 1e-05
    mamba_head_dim: int = 64
    mamba_hidden_act: str = "silu"
    mamba_num_heads: int = 64
    mamba_proj_bias: bool = False
    max_position_embeddings: int = 262144
    mlp_bias: bool = False
    mlp_hidden_act: str = "relu2"
    model_type: str = "nemotron_h"
    moe_intermediate_size: int = 1856
    moe_shared_expert_intermediate_size: int = 3712
    n_group: int = 1
    n_groups: int = 8
    n_routed_experts: int = 128
    n_shared_experts: int = 1
    norm_eps: float = 1e-05
    norm_topk_prob: bool = True
    num_attention_heads: int = 32
    num_experts_per_tok: int = 6
    num_hidden_layers: int = 52
    num_key_value_heads: int = 2
    num_logits_to_keep: int = 1
    partial_rotary_factor: float = 1.0
    rescale_prenorm_residual: bool = True
    residual_in_fp32: bool = False
    rope_theta: float = 10000.0
    routed_scaling_factor: float = 2.5
    sliding_window: Optional[int] = None
    ssm_state_size: int = 128
    tie_word_embeddings: bool = False
    time_step_floor: float = 0.0001
    time_step_max: float = 0.1
    time_step_min: float = 0.001
    topk_group: int = 1
    use_bias: bool = False
    use_conv_bias: bool = True
    use_mamba_kernels: bool = True
    vocab_size: int = 131072


@dataclass(frozen=True)
class LinearAttnConfig:
    """Kimi Linear's ``linear_attn_config``: which layers (counted from 1)
    are KDA and which full attention (MLA), and the KDA heads."""
    full_attn_layers: Tuple[int, ...] = (4, 8, 12, 16, 20, 24, 27)
    head_dim: int = 128
    kda_layers: Tuple[int, ...] = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15,
                                   17, 18, 19, 21, 22, 23, 25, 26)
    num_heads: int = 32
    short_conv_kernel_size: int = 4


@dataclass(frozen=True)
class KimiLinearConfig:
    """A Kimi Linear decoder LM as a query tower (Kimi Linear,
    arXiv:2510.26692), by the keys of its published ``config.json``
    (defaults: Kimi-Linear-48B-A3B-Instruct, https://huggingface.co/
    moonshotai/Kimi-Linear-48B-A3B-Instruct): KDA token mixers and NoPE MLA
    ones by ``linear_attn_config``, a dense SwiGLU MLP in the first
    ``first_k_dense_replace`` layers and a sigmoid-routed SwiGLU MoE with
    shared experts after.  Keys naming no inference step (RoPE, which
    ``mla_use_nope`` turns off, the context length, the LM head) are kept
    so that the configuration reads as published;
    ``models/kimi_linear.py::check`` refuses values whose mathematics the
    port does not implement.

    ``held_experts`` is the port's own key: (the first expert id, the
    count) that this card holds of every MoE layer, the router still
    choosing over all ``num_experts``; None holds them all."""
    first_k_dense_replace: int = 1
    head_dim: int = 72
    hidden_act: str = "silu"
    hidden_size: int = 2304
    intermediate_size: int = 9216
    kv_lora_rank: int = 512
    linear_attn_config: LinearAttnConfig = field(
        default_factory=LinearAttnConfig)
    mla_use_nope: bool = True
    model_max_length: int = 1048576
    model_type: str = "kimi_linear"
    moe_intermediate_size: int = 1024
    moe_layer_freq: int = 1
    moe_renormalize: bool = True
    moe_router_activation_func: str = "sigmoid"
    num_attention_heads: int = 32
    num_expert_group: int = 1
    num_experts: int = 256
    num_experts_per_token: int = 8
    num_hidden_layers: int = 27
    num_key_value_heads: int = 32
    num_nextn_predict_layers: int = 0
    num_shared_experts: int = 1
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    rms_norm_eps: float = 1e-05
    rope_scaling: Optional[Dict[str, Any]] = None
    rope_theta: float = 10000.0
    routed_scaling_factor: float = 2.446
    tie_word_embeddings: bool = False
    topk_group: int = 1
    use_grouped_topk: bool = True
    v_head_dim: int = 128
    vocab_size: int = 163840
    held_experts: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        # a section read from JSON (a file's decoder keys) gives the nested
        # config as a dict and tuples as lists
        lac = self.linear_attn_config
        if isinstance(lac, dict):
            object.__setattr__(self, "linear_attn_config", LinearAttnConfig(
                **_tuplify(LinearAttnConfig, lac)))
        if isinstance(self.held_experts, list):
            object.__setattr__(self, "held_experts",
                               tuple(self.held_experts))


# the decoder sections, by their published ``model_type``
DECODERS = {"nemotron_h": DecoderConfig, "kimi_linear": KimiLinearConfig}


def decoder_from_dict(d: Dict[str, Any]):
    """The decoder section of a JSON dict, its class picked by
    ``model_type``."""
    kind = d.get("model_type")
    if kind not in DECODERS:
        raise ValueError(f"no decoder section of model_type {kind!r} "
                         f"(have {sorted(DECODERS)})")
    cls = DECODERS[kind]
    return cls(**_tuplify(cls, d))


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 64
    num_epochs: int = 30
    steps_per_epoch: int = 0            # 0 = derive from dataset size
    learning_rate: float = 1e-3
    optimizer: str = "adam"             # "adam" | "sgd" | "adamw"
    lr_schedule: str = "constant"       # "constant" | "cosine" | "step"
    warmup_steps: int = 0
    lr_decay_steps: int = 0             # step schedule: decay every N steps
    lr_decay_rate: float = 0.5
    momentum: float = 0.9
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0         # 0 = off
    # Exponential moving average of the parameters (Polyak averaging):
    # > 0 maintains ema <- d*ema + (1-d)*params after every optimizer step
    # (inside the fused multi-step scan — one tree of FMAs over ~10 MB of
    # params, free next to the step's GEMMs) and uses the EMA weights for
    # eval/checkpointed serving while raw params keep training.  Contrastive
    # recipes are noisy near convergence; the average is the standard
    # variance-reduction knob.  0 = off (exact pre-EMA program).
    ema_decay: float = 0.0
    # Objective.  "triplet" is the reference-lineage max-margin ranking loss
    # (BASELINE.json:5); "infonce" is a softmax contrastive alternative
    # (one cross-entropy over the same [B,B,P] cross-distance tensor +
    # mined hard negatives — all-matmul, TPU-native by construction).
    loss_type: str = "triplet"          # "triplet" | "infonce"
    # infonce: softmax over -distance/tau.  Every measured working tau is
    # 0.015-0.05 (metric- and scale-dependent, docs/DESIGN.md 27/28); the
    # old default 0.1 was the exact value the mis-tuned-init collapse demo
    # used (VERDICT r3 weak #4).  0.05 = the sqeuclidean 10k-video optimum;
    # the flagship presets carry the cosine optimum 0.02.
    temperature: float = 0.05
    # CLIP-style learnable temperature: when True (infonce only), tau is a
    # trained parameter (params["log_tau"], initialized at `temperature`,
    # exp()'d and clamped to [5e-3, 1.0] in the loss).  Measured at spec
    # scale (docs/DESIGN.md 29): matches fixed tau when initialized at the
    # optimum but DIVERGES from a mis-tuned init — opt-in, not a sweep
    # replacement.
    learn_temperature: bool = False
    # Temperature anneal (infonce only): > 0 schedules tau from
    # `temperature` down to `temperature_final` over training with a
    # cosine ramp — soft softmax while the model is weak (the low-tau
    # stall, DESIGN 28), sharp once it can rank.  Rides each chunk as a
    # per-step operand, so changing the schedule never recompiles.
    # Mutually exclusive with learn_temperature.
    temperature_final: float = 0.0      # 0 = constant temperature
    # Symmetric InfoNCE (infonce only): weight of the REVERSE cross-entropy
    # — each ground-truth moment classifying its query against the other
    # batch queries (CLIP's two-directional objective).  Reuses the same
    # [B, B, P] tensor (one gather, no extra matmul).  0 = off (the
    # committed one-directional objective).
    lambda_inter_rev: float = 0.0
    margin: float = 0.1                 # triplet ranking margin
    lambda_intra: float = 1.0
    lambda_inter: float = 0.2
    inter_negatives: str = "same_span"  # "same_span" | "all_spans"
    # Index-based HARD inter-video negative mining (BASELINE.json:5
    # "inter-video negative mining" — the strong form).  In-batch negatives
    # satisfy the margin against ~B rivals and stop learning there
    # (measured: inter loss -> 0 while corpus recall stays ~4x chance);
    # mining re-ranks the full corpus index every refresh and trains
    # against each query's actual nearest wrong-video moments.
    hard_negative_count: int = 0        # mined negatives per query (0 = off)
    hard_negative_refresh_epochs: int = 1
    hard_negative_start_epoch: int = 1  # first epoch that mines (params
                                        # must be non-random to mine well)
    lambda_hard: float = 0.0            # weight; 0.0 = reuse lambda_inter
    target_sampling: str = "mode"       # "mode" (annotator consensus) |
                                        # "sample" (random annotator / step)
    # Best-checkpoint tracking: name a val metric (e.g. "R@1_tiou0.5",
    # "mIoU") and every eval that improves it rolls <ckpt_dir>/best.msgpack
    # (params + EMA + config, same payload as step checkpoints; excluded
    # from retention GC and from --resume's latest_checkpoint view).
    # eval/corpus/serve/index open it with --best.  "" = off.
    best_metric: str = ""
    seed: int = 42
    checkpoint_dir: str = "checkpoints"
    checkpoint_every_epochs: int = 1
    eval_every_epochs: int = 1          # val-metrics cadence; the LAST epoch
                                        # always evaluates (final_metrics).
                                        # At spec scale per-epoch eval is
                                        # ~29% of total wall (DESIGN 18) —
                                        # raise for long runs.
    keep_checkpoints: int = 3
    log_every_steps: int = 20
    steps_per_call: int = 0             # optimizer steps fused per dispatch
                                        # via lax.scan (0 = log_every_steps);
                                        # amortizes program-launch overhead
    metrics_path: str = ""              # "" = <checkpoint_dir>/metrics.jsonl
    data_parallel: bool = False         # shard batch over mesh axis "data"
    prefetch_depth: int = 2             # host->HBM double buffering depth


# Measured InfoNCE temperature bands, recorded as DATA (VERDICT r4 weak
# #1 / next #5): every row below is a deterministic-grid measurement at
# the 10k-video spec-scale fixture (docs/DESIGN.md 27/28/32/33/35/36 and
# artifacts/sweep_*.json), keyed by (ModelConfig.distance,
# ModelConfig.query_pool).  "band" = the tau range where corpus video
# R@1 stayed within ~25% of the combo's measured peak; outside it the
# grid measured decay (high side) or the stall cliff / outright collapse
# (low side: tau .015 stalls cosine, B=512-family collapse at .040 for
# d256).  "peak_by_batch" records that the band peak moves with the
# in-batch negative population (DESIGN 33: B=64 -> .02, B=128 -> .03
# under last pooling) and with the pooling variance (DESIGN 35: mean
# pooling re-tempers DOWN to .018).  Combos not listed were never
# measured — no guardrail fires for them.
INFONCE_TAU_BANDS: Dict[Tuple[str, str], Dict[str, Any]] = {
    ("cosine", "last"): {
        "band": (0.016, 0.035),
        "peak_by_batch": {64: 0.02, 128: 0.03},
        "design": "27/28/32/33",
    },
    ("cosine", "mean"): {
        # B=128 from the DiDeMo grid (DESIGN 35); B=64 from the Charades
        # mean-pool port (DESIGN 37: .018/.020 tied at the peak, decay by
        # .012) — the band itself transfers across both fixtures
        "band": (0.016, 0.028),
        "peak_by_batch": {64: 0.02, 128: 0.018},
        "design": "35/37",
    },
    ("cosine", "attn"): {
        # attention pooling measured within seed jitter of the mean
        # (DESIGN 36) — it inherits the mean-pool band
        "band": (0.016, 0.028),
        "peak_by_batch": {128: 0.018},
        "design": "36",
    },
    ("sqeuclidean", "last"): {
        # 10k-video grid: .015 -> 0.0503, .05 -> 0.0600 (peak),
        # .1 -> 0.0510 (DESIGN 27) — wide and shallow
        "band": (0.015, 0.1),
        "peak_by_batch": {64: 0.05},
        "design": "27",
    },
}


def infonce_tau_warning(cfg: "ExperimentConfig") -> str | None:
    """Return a warning string when an InfoNCE run is configured with a
    temperature OUTSIDE the measured band for its (distance, query_pool)
    combination — the silent footgun VERDICT r4 weak #1 named: the
    dataclass default tau 0.05 is the sqeuclidean optimum, but over
    cosine distance the measured band decays past ~0.028 and the grid
    hit collapse by 0.040.  None = no measured band for the combo, or
    tau is inside it.  Learnable/annealed temperature runs are exempt
    (they move tau themselves)."""
    t = cfg.train
    if t.loss_type != "infonce" or t.learn_temperature:
        return None
    if t.temperature_final > 0:        # annealed: endpoint governs
        tau = t.temperature_final
    else:
        tau = t.temperature
    key = (cfg.model.distance, cfg.model.query_pool)
    row = INFONCE_TAU_BANDS.get(key)
    if row is None:
        return None
    lo, hi = row["band"]
    if lo <= tau <= hi:
        return None
    peaks = ", ".join(f"B={b}: tau~{p}" for b, p in
                      sorted(row["peak_by_batch"].items()))
    return (
        f"InfoNCE temperature {tau} is outside the measured band "
        f"[{lo}, {hi}] for distance={cfg.model.distance!r} / "
        f"query_pool={cfg.model.query_pool!r} (measured peaks: {peaks}; "
        f"docs/DESIGN.md {row['design']}).  Below the band the softmax "
        "stalls at init; above it recall decays toward collapse.  Set "
        "--temperature inside the band or use a flagship preset "
        "(didemo_flagship / charades_flagship), which carries the "
        "measured optimum."
    )


@dataclass(frozen=True)
class EvalConfig:
    recall_ks: Tuple[int, ...] = (1, 5)
    tiou_thresholds: Tuple[float, ...] = (0.5, 0.7)
    protocol: str = "threshold"         # "threshold" | "didemo_official"
    eval_batch_size: int = 256
    # Corpus-level retrieval / serving.
    corpus_shards: int = 1              # devices to shard the moment index over
    corpus_topk: int = 100
    corpus_query_batch: int = 128
    corpus_num_videos: int = 0          # 0 = whole dataset
    # top-k selection: "exact" (lax.top_k) or "approx"
    # (lax.approx_max_k — TPU PartialReduce; measured 73x faster at
    # [128 x 210k], k=100 for a 0.95 recall target)
    topk_method: str = "exact"
    approx_recall: float = 0.95
    # Query-RNN implementation for METRICS eval: "scan" = the f32 lax.scan
    # twin (same precision as training — reported metrics are bit-comparable
    # to the trained model); "pallas" = the VMEM-resident bf16-weight kernel
    # (serving precision).  Serving paths (serve/bench) default to pallas
    # via the use_pallas policy regardless of this knob.
    rnn_kernel: str = "scan"
    # Moment-index storage dtype for corpus retrieval/serving: "bfloat16"
    # halves HBM traffic on the bandwidth-bound distance stage (the index is
    # streamed in full per query batch); distances accumulate in f32 either
    # way.  "float32" = exact.
    index_dtype: str = "float32"
    # Eval-side twin of DataConfig.bank_dtype: storage dtype for feature
    # banks built inside evaluate() when none are passed in.
    bank_dtype: str = "float32"
    # Coarse-to-fine two-stage retrieval (eval/coarse.py): 0 = full scan
    # (exact one-matmul score stage, the recommended default at every
    # scale — DESIGN 21); >0 = PCA-prefilter rank, opt-in.  Measured
    # trade-offs (recall grids + 2.1M-row timings) live in
    # artifacts/coarse_scale.json — block-granularity candidate sets cost
    # real recall on trained embeddings (blockmax d64/C2048: recall@1
    # 0.91, recall@10 0.55 vs exact), so only deployments that can trade
    # recall for HBM bytes should turn this on.  coarse_mode: "blockmax"
    # (exact per-block stage-1 maxima, better recall) or "centroid"
    # (IVF-style fixed-size cells, stage 1 ~N/128 cheaper, weaker recall).
    coarse_dim: int = 0
    coarse_candidates: int = 2048
    coarse_mode: str = "blockmax"


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "didemo_rgb"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    # the decoder LM that is the query tower in place of the LSTM or GRU
    # (a section of ``DECODERS``, by its ``model_type``); None for the RNN
    # towers.  The port alone has it: out of the repr (the index
    # fingerprint hashes repr(cfg), and a query tower leaves the moment
    # rows alone) and, at None, out of ``to_json``, so the JAX package's
    # presets read the same in both
    decoder: Optional[Any] = field(default=None, repr=False)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if self.decoder is None:
            del d["decoder"]
        return json.dumps(d, indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "ExperimentConfig":
        d = json.loads(s)
        dec = d.get("decoder")
        return ExperimentConfig(
            name=d["name"],
            data=DataConfig(**_tuplify(DataConfig, d["data"])),
            model=ModelConfig(**_tuplify(ModelConfig, d["model"])),
            train=TrainConfig(**_tuplify(TrainConfig, d["train"])),
            eval=EvalConfig(**_tuplify(EvalConfig, d["eval"])),
            decoder=None if dec is None else decoder_from_dict(dec),
        )

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def _tuplify(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    """JSON round-trips tuples as lists; coerce back per-field."""
    out = {}
    hints = {f.name: f.type for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k in hints and isinstance(v, list):
            out[k] = tuple(v)
        else:
            out[k] = v
    return out


def _didemo_data(**kw) -> DataConfig:
    return DataConfig(dataset="didemo", num_clips=6, clip_seconds=5.0, **kw)


PRESETS: Dict[str, ExperimentConfig] = {}


def _register(cfg: ExperimentConfig) -> ExperimentConfig:
    PRESETS[cfg.name] = cfg
    return cfg


# 1. DiDeMo RGB-only (CPU-runnable slice).  [BASELINE.json:7]
_register(ExperimentConfig(
    name="didemo_rgb",
    data=_didemo_data(use_flow=False),
    model=ModelConfig(stream_weights=(1.0,), use_tef=True),
    train=TrainConfig(),
    eval=EvalConfig(),
))

# 2. Two-stream RGB + flow fusion with TEF.  [BASELINE.json:8]
_register(ExperimentConfig(
    name="didemo_fusion",
    data=_didemo_data(use_flow=True),
    model=ModelConfig(stream_weights=(0.5, 0.5), use_tef=True),
    train=TrainConfig(),
    eval=EvalConfig(),
))

# 3. Charades-STA sliding-window proposals.  [BASELINE.json:9]
_register(ExperimentConfig(
    name="charades_sta",
    data=DataConfig(
        dataset="charades_sta",
        data_dir="data/charades",
        window_scales=(12.0, 18.0, 24.0),
        window_stride_ratio=0.25,
        max_windows=64,
        use_flow=False,
    ),
    model=ModelConfig(stream_weights=(1.0,), use_tef=True),
    train=TrainConfig(margin=0.2),
    eval=EvalConfig(tiou_thresholds=(0.5, 0.7)),
))

# 4. Corpus-level retrieval, index sharded over ICI.  [BASELINE.json:10]
_register(ExperimentConfig(
    name="corpus_didemo",
    data=_didemo_data(use_flow=True),
    model=ModelConfig(stream_weights=(0.5, 0.5), use_tef=True),
    train=TrainConfig(lambda_inter=0.5),
    eval=EvalConfig(corpus_shards=8, corpus_topk=100, corpus_query_batch=128),
))

# 5. Large-scale serving: cached index, batched top-k over 10k videos.
#    [BASELINE.json:11]
_register(ExperimentConfig(
    name="serving_10k",
    data=_didemo_data(use_flow=True, synthetic_num_videos=10_000,
                      synthetic_num_queries=1024),
    model=ModelConfig(stream_weights=(0.5, 0.5), use_tef=True,
                      compute_dtype="bfloat16"),
    train=TrainConfig(),
    eval=EvalConfig(corpus_shards=8, corpus_topk=100, corpus_query_batch=256,
                    topk_method="approx",
                    # bf16 index: halves the HBM bytes of the bandwidth-bound
                    # distance stage; ranking parity vs f32 is gated by
                    # tests/test_corpus.py::TestIndexDtype
                    index_dtype="bfloat16"),
))


# 5b. The serving_10k deployment with a decoder LM as the query tower:
#     NVIDIA-Nemotron-3-Nano-30B-A3B (Mamba-2, a 128-expert MoE with a
#     shared expert, GQA) at its published widths, stopped at the final
#     norm, its last live token projected to the joint space; bf16
#     weights.  The port alone has it (no counterpart in the JAX package).
_register(ExperimentConfig(
    name="nemotron3_nano_serving",
    data=PRESETS["serving_10k"].data,
    model=dataclasses.replace(PRESETS["serving_10k"].model,
                              param_dtype="bfloat16"),
    train=TrainConfig(),
    eval=PRESETS["serving_10k"].eval,
    decoder=DecoderConfig(),
))

# 5c. The serving_10k deployment with Kimi-Linear-48B-A3B-Instruct as the
#     query tower (KDA, NoPE MLA, a 256-expert SwiGLU MoE with a shared
#     expert) at its published widths, bf16 weights, as one card of a
#     deployment that shares every MoE layer's experts over two cards by
#     expert parallelism: this card holds experts 0-127 of 256.
_register(ExperimentConfig(
    name="kimi_linear_serving",
    data=PRESETS["serving_10k"].data,
    model=dataclasses.replace(PRESETS["serving_10k"].model,
                              param_dtype="bfloat16"),
    train=TrainConfig(),
    eval=PRESETS["serving_10k"].eval,
    decoder=KimiLinearConfig(held_experts=(0, 128)),
))


# 6-7. The FLAGSHIP quality recipe as a named preset (VERDICT r3 missing
# #2): the measured-best training configuration this repo proved at spec
# scale — InfoNCE over COSINE distance, batch 128 (the in-batch negative
# population is the lever that moved, DESIGN 33), tau 0.03 (the band
# re-tempered for the 2x population), index-mined hard negatives
# (count 8, refresh 1), Polyak averaging 0.999.  Earned the hard way:
# corpus video R@1 0.0312 (triplet default) -> 0.139 (r3 recipe) ->
# 0.258 at 10k videos / 210k rows (docs/DESIGN.md 26-33; committed
# artifact artifacts/quality_large/final_metrics.json, regression-
# gated).  A user should get the repo's best recipe with ONE flag.
def _flagship_train(**kw) -> TrainConfig:
    kw.setdefault("batch_size", 128)   # 2x in-batch InfoNCE negatives:
                                       # +47% alone; knee — 256 loses,
                                       # 512 stalls (DESIGN 33)
    kw.setdefault("temperature", 0.018)  # band peak under MEAN query
                                         # pooling at B=128 (.018-.020
                                         # indistinguishable at seed
                                         # jitter; decay past ~.028 —
                                         # DESIGN 35.  Last-pool wanted
                                         # .03: tau re-tempers DOWN with
                                         # the lower-variance mean)
    return TrainConfig(
        num_epochs=20,
        loss_type="infonce",
        lambda_inter=1.0,
        inter_negatives="all_spans",
        ema_decay=0.999,           # +22% corpus video R@1 at zero step cost
        hard_negative_count=8,
        hard_negative_start_epoch=3,
        hard_negative_refresh_epochs=1,
        **kw,
    )


_register(ExperimentConfig(
    name="didemo_flagship",
    data=_didemo_data(use_flow=True),
    # query_pool="mean": the length-masked mean over LSTM states beats
    # the final-state summary by +85% corpus video R@1 (0.258 -> 0.478,
    # DESIGN 35; across n=4 seeds 0.468 +/- 0.012, DESIGN 38); learned
    # attention pooling and symmetric InfoNCE both measured within seed
    # jitter of it — the simple mean is the recipe
    model=ModelConfig(stream_weights=(0.5, 0.5), use_tef=True,
                      distance="cosine", query_pool="mean"),
    train=_flagship_train(),
    eval=EvalConfig(eval_batch_size=512, corpus_query_batch=256),
))

_register(ExperimentConfig(
    name="charades_flagship",
    data=DataConfig(
        dataset="charades_sta",
        data_dir="data/charades",
        window_scales=(12.0, 18.0, 24.0),
        window_stride_ratio=0.25,
        max_windows=64,
        use_flow=False,
    ),
    # query_pool stays "last": the DiDeMo mean-pool lever was swept here
    # across the re-tempered tau band (DESIGN 37) — its peak (0.9215 at
    # tau .018) lands INSIDE the last-pool regeneration band, so the
    # simpler pool keeps the preset
    model=ModelConfig(stream_weights=(1.0,), use_tef=True,
                      distance="cosine"),
    # the batch/tau operating point is DATASET-specific: Charades' 14k
    # training queries give only ~109 steps/epoch at B=128 and its 2k-video
    # corpus is near-saturated — measured (DESIGN 33): B=128/tau.03 0.8715,
    # B=128/tau.02 worse than committed too; B=64/tau.02 stays the peak
    # (corpus video R@1 0.91-0.92 across regenerations, 0.9065 at seed 1;
    # the committed artifact — the number the gate holds — records 0.91)
    train=_flagship_train(margin=0.2, batch_size=64, temperature=0.02),
    eval=EvalConfig(tiou_thresholds=(0.5, 0.7), eval_batch_size=512,
                    corpus_query_batch=256),
))


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
