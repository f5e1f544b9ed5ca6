"""Core layers of the dense decoder, in PyTorch.

Port of the JAX package's ``models/layers.py`` for serving and training:

  * params are plain nested dicts of tensors (f32 masters), declared
    through ``ParamSpec``s with the same paths and shapes as the reference,
    so snapshot images of either package name the same entries;
  * compute runs in the activations' dtype; masters are cast per use;
  * attention is query-chunked above ``CHUNK_THRESHOLD``, so a long
    prefill never materialises an (S x S) score tensor.

Sharding constraints of the reference have no counterpart on one device.
Across ranks the reference's constraints pin q, k and v to ``heads`` /
``kv_heads``, the MLP's hidden to ``d_ff`` and the logits to ``vocab``
over the policy's ``tp`` axes; the port computes the same split by hand
where a :class:`sharding.policy.TensorShard` says a kind is cut
(:func:`tensor_shard`, from the call's gather): the layers here take a
rank's blocks of the weights as they are given (the head counts come from
the weights' shapes), :func:`kv_for_heads` picks the key heads a rank's
query heads pair with, and :func:`row_sum` adds a row-parallel output
over the ranks (``distributed.AllReduce``, whose backward sums the
grads as the transpose of ``psum``), while :func:`column_input` marks
the activation that column-parallel products read
(``distributed.ColumnInput``: its backward reduces each product's grads
over the ranks and averages them, so that, with the trainer's loss
weighted by a rank's share over the ranks of its row, every rank's
activation grads are the same share of the whole, and the gathers'
reduce-scatter counts each token once).  The vocab split has its own
embedding lookup (:func:`embed`), head, cross-entropy (:func:`_xent_nll`:
the max, the sum of exp and the target logit, each reduced over the
ranks) and greedy pick (:func:`greedy`).  A split whose group is None (a
rank that one process emulates, ``sharding.policy.rank_view``) runs no
collective: :func:`row_sum` and :func:`column_input` refuse it, and its
callers take the rank's partial output before the sum
(``LM._attn_partial``, :func:`mlp`).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import zlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

PyTree = Any

CHUNK_THRESHOLD = 8192     # chunk queries when S >= this
QUERY_CHUNK = 1024

# ---- the dry run's variant knobs (``launch/dryrun.py --variant``) ----
# dtype the attention score/prob matrices of training and prefill
# materialise in (f32: the baseline; the flash kernel keeps them on chip)
SCORE_DTYPE = torch.float32
# sequence-chunked cross-entropy: when > 0 the (B, S, V) logit loss is
# computed in S/chunk pieces, bounding the live f32 logit intermediates
XENT_SEQ_CHUNK = 0
# GQA -> MHA expansion of K/V in the training forward (the reference's
# fix for KV heads that do not divide the tensor-parallel degree)
GQA_EXPAND = False
# cast the f32 master params to the compute dtype once at the training
# forward's entry, so FSDP's gathers move the compute dtype
CAST_PARAMS_ONCE = False


def maybe_cast_params(params: PyTree, dtype) -> PyTree:
    """With ``CAST_PARAMS_ONCE``: every f32 leaf cast to `dtype`
    (differentiable: the grads reach the f32 masters); else `params`."""
    if not CAST_PARAMS_ONCE:
        return params
    if isinstance(params, dict):
        return {k: maybe_cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.dtype == torch.float32 else params


# ======================================================================
# Params held in blocks across ranks
# ======================================================================
_GATHER: contextvars.ContextVar = contextvars.ContextVar("gather",
                                                         default=None)


@contextlib.contextmanager
def gathering(gather):
    """The models' calls in this block read their params through
    ``gather(tree, *path)``: the whole tensors of `tree`, a rank's blocks
    of the params' subtree at `path` (keys from the root) or of one layer
    of a stacked subtree (``sharding.policy.param_gather``).  A model
    gathers each layer where it reads it, inside its remat unit, and the
    top-level leaves once a call; it holds no mesh or policy.  The same
    gather carries the MoE block's place across ranks
    (:func:`expert_shard`): its expert leaves come gathered over the
    data axes alone, a rank's own experts whole.  Outside any block (or
    with None) the params are whole."""
    token = _GATHER.set(gather)
    try:
        yield
    finally:
        _GATHER.reset(token)


def expert_shard(gather):
    """The MoE block's place across ranks that `gather` carries
    (``sharding.policy.ExpertShard``), or None: one rank holds every
    expert."""
    return getattr(gather, "experts", None)


def tensor_shard(gather):
    """The dense layers' place across ranks that `gather` carries
    (``sharding.policy.TensorShard``), or None: computed whole."""
    return getattr(gather, "tensor", None)


def tp_units(cfg) -> Dict[str, int]:
    """The heads of `cfg`'s attention: a tensor-parallel split cuts the
    H·hd columns of a projection by whole heads only
    (``sharding.policy.tp_axes``)."""
    return {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads}


def cut(tp, kind: str):
    """The ``sharding.policy.Split`` of `kind` in the TensorShard `tp`,
    or None: computed whole."""
    return getattr(tp, kind) if tp is not None else None


def _group(split):
    """`split`'s group.  A split without one is a rank that one process
    emulates (``sharding.policy.rank_view``): it has no collectives, and
    its caller sums the ranks' partial outputs itself."""
    if split.group is None:
        raise ValueError("a split without a group (a rank that one "
                         "process emulates) reduces over no ranks: sum "
                         "the ranks' partial outputs instead")
    return split.group


def column_input(x: torch.Tensor, split, n: int = 1):
    """`x` as `n` column-parallel products over `split` read it (``n``
    views, or `x` itself at ``n == 1``): each product's grads reduced
    over the ranks on their own in the backward
    (``distributed.ColumnInput``).  `x` itself without a split."""
    if split is None:
        return x if n == 1 else (x,) * n
    from repro_torch.distributed import ColumnInput
    out = ColumnInput.apply(x, _group(split), n)
    return out[0] if n == 1 else out


def row_sum(partial: torch.Tensor, split) -> torch.Tensor:
    """A row-parallel product's output: the rank's partial summed in f32
    over the ranks of `split` and cast back (one all-reduce); `partial`
    itself without a split."""
    if split is None:
        return partial
    from repro_torch.distributed import AllReduce
    return AllReduce.apply(partial.float(), _group(split)).to(
        partial.dtype)


def no_gather(tree, *path):
    """The gather of whole params: `tree` itself."""
    return tree


def current_gather():
    """The gather of the innermost :func:`gathering` block, or None.  A
    model reads it once at a call's entry and hands it on: a backward's
    recompute may run on another thread, outside the block."""
    return _GATHER.get()


# ======================================================================
# Param declaration
# ======================================================================
@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis names
    init: str = "normal"                     # normal | zeros | ones
    scale: Optional[float] = None            # stddev for "normal"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _leaf_paths(tree: PyTree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _stable_hash(s: str) -> int:
    """Process-independent string hash (Python's hash() is salted)."""
    return zlib.crc32(s.encode()) & 0x7FFFFFFF


def _set_path(out: Dict[str, Any], path, value) -> None:
    node = out
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def init_params(specs: PyTree, seed: int, dtype=torch.float32,
                device="cpu") -> PyTree:
    """Materialise a param tree from ParamSpecs, deterministic per path:
    each leaf draws from its own ``torch.Generator`` seeded by (seed,
    path).  The numbers differ from ``jax.random``'s; weights cross
    between the packages as numpy (``models.convert``) or in an image."""
    out: Dict[str, Any] = {}
    for path, spec in _leaf_paths(specs):
        if spec.init == "zeros":
            t = torch.zeros(spec.shape, dtype=dtype, device=device)
        elif spec.init == "ones":
            t = torch.ones(spec.shape, dtype=dtype, device=device)
        else:
            leaf_seed = seed
            for p in path:
                leaf_seed = (leaf_seed * 1000003 + _stable_hash(p)) % (1 << 63)
            gen = torch.Generator(device=device).manual_seed(leaf_seed)
            scale = spec.scale
            if scale is None:
                fan_in = spec.shape[0] if len(spec.shape) >= 1 else 1
                scale = 1.0 / math.sqrt(max(1, fan_in))
            t = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                            device=device).mul_(scale).to(dtype)
        _set_path(out, path, t)
    return out


def abstract_params(specs: PyTree, dtype=torch.float32) -> PyTree:
    """Shape/dtype-only tree on the ``meta`` device (no allocation)."""
    out: Dict[str, Any] = {}
    for path, spec in _leaf_paths(specs):
        _set_path(out, path, torch.empty(spec.shape, dtype=dtype,
                                         device="meta"))
    return out


def axes_tree(specs: PyTree) -> PyTree:
    """The logical axes of every param, in the param tree's structure
    (tuples as leaves): what a sharding policy lays over a mesh."""
    out: Dict[str, Any] = {}
    for path, spec in _leaf_paths(specs):
        _set_path(out, path, spec.axes)
    return out


def stack_specs(specs: PyTree, n: int) -> PyTree:
    """Add a leading ("layers") dim of size n to every ParamSpec."""
    if isinstance(specs, dict):
        return {k: stack_specs(v, n) for k, v in specs.items()}
    return ParamSpec((n,) + specs.shape, ("layers",) + specs.axes,
                     specs.init, specs.scale)


# ======================================================================
# Normalisation
# ======================================================================
def rmsnorm_spec(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), ("d_model",), init="ones")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5,
            use_kernels: bool = False) -> torch.Tensor:
    """The block norm; with ``use_kernels`` through the RMSNorm kernel,
    which computes the same function (``ops.rmsnorm``)."""
    if use_kernels:
        from repro_torch.kernels import ops
        return ops.rmsnorm(x, params["scale"], eps=eps)
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                 eps: float = 1e-5, use_kernels: bool = False
                 ) -> torch.Tensor:
    """Per-head q/k norm (Qwen3): x (..., hd), scale (hd,); with
    ``use_kernels`` through the RMSNorm kernel, one row per (token,
    head).  The reference computes it outside any kernel: the same
    function."""
    return rmsnorm({"scale": scale}, x, eps, use_kernels)


# ======================================================================
# Rotary embeddings
# ======================================================================
def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """M-RoPE's (temporal, height, width) split of the head_dim/2
    frequencies, e.g. hd 128 -> (16, 24, 24)."""
    half = head_dim // 2
    s = 3 * half // 8
    return (half - 2 * s, s, s)


def image_positions(B: int, S: int, grid: Tuple[int, int]) -> torch.Tensor:
    """The ``positions`` entry (3, B, S) int32 of a VLM batch whose
    prompts open with one image's h*w patches on an h x w grid (t = 0,
    h = row, w = col), text token i at i in all three components: what a
    caller gives ``DecodeServer.start`` (or ``LM.prefill``) for such a
    prompt, since decode puts the cache index in all three components
    and so continues this layout alone."""
    h, w = grid
    if h * w > S:
        raise ValueError(f"a {h}x{w} grid does not fit in {S} tokens")
    pos = torch.arange(S, dtype=torch.int32).repeat(3, 1)
    patch = torch.arange(h * w, dtype=torch.int32)
    pos[0, :h * w] = 0
    pos[1, :h * w] = patch // w
    pos[2, :h * w] = patch % w
    return pos[:, None, :].expand(3, B, S).contiguous()


def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    """Inverse frequencies in f64, made on `device` (no host->device copy,
    which would stall the launch queue on every call)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float64, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope: bool = False) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S), or (3, B, S) for M-RoPE,
    where frequency section i (``mrope_sections``) turns by component i."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(hd, theta, x.device).float()              # (half,)
    if mrope:
        parts, start = [], 0
        for i, n in enumerate(mrope_sections(hd)):
            parts.append(positions[i].float()[..., None]
                         * freqs[start:start + n])
            start += n
        angles = torch.cat(parts, dim=-1)                        # (B,S,half)
    else:
        angles = positions.float()[..., None] * freqs            # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :]                       # (B,S,1,half)
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ======================================================================
# Attention
# ======================================================================
def attention_specs(cfg) -> Dict[str, ParamSpec]:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s: Dict[str, ParamSpec] = {
        "wq": ParamSpec((d, H * hd), ("d_model", "heads")),
        "wk": ParamSpec((d, KV * hd), ("d_model", "kv_heads")),
        "wv": ParamSpec((d, KV * hd), ("d_model", "kv_heads")),
        "wo": ParamSpec((H * hd, d), ("heads", "d_model")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H * hd,), ("heads",), init="zeros")
        s["bk"] = ParamSpec((KV * hd,), ("kv_heads",), init="zeros")
        s["bv"] = ParamSpec((KV * hd,), ("kv_heads",), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
        s["k_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
    return s


def _qkv(params, cfg, x, positions: Optional[torch.Tensor],
         rope: bool = True, use_kernels: bool = False):
    """Project `x` (B,S,d), or the three views (q's, k's, v's) that
    :func:`column_input` gives, to q (B,S,H,hd), k/v (B,S,KV,hd),
    q/k-normed per head (Qwen3, through the RMSNorm kernel with
    ``use_kernels``) when the config asks, with RoPE (M-RoPE for a
    ``cfg.mrope`` config, positions (3, B, S)) applied.  H and KV are the
    heads of the weights given: a rank's blocks of a split attention give
    its own."""
    xq, xk, xv = x if isinstance(x, tuple) else (x, x, x)
    B, S, _ = xq.shape
    hd = cfg.head_dim
    H, KV = params["wq"].shape[-1] // hd, params["wk"].shape[-1] // hd
    dt = xq.dtype
    q = xq @ params["wq"].to(dt)
    k = xk @ params["wk"].to(dt)
    v = xv @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = head_rmsnorm(params["q_norm"], q, cfg.norm_eps, use_kernels)
        k = head_rmsnorm(params["k_norm"], k, cfg.norm_eps, use_kernels)
    if rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)
    return q, k, v


def _sdpa_block(q, k, v, mask, scale):
    """q (B,Q,KV,rep,hd), k/v (B,Sk,KV,hd), mask (Q,Sk) bool or None."""
    scores = torch.einsum("bqgrd,bkgd->bgrqk", q, k) * scale
    scores = scores.to(SCORE_DTYPE)
    if mask is not None:
        neg = -1e30 if SCORE_DTYPE == torch.float32 else -3e38
        scores = torch.where(mask, scores, neg)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bgrqk,bkgd->bqgrd", probs, v)


def maybe_expand_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """With ``GQA_EXPAND``: K/V (B,S,KV,hd) repeated over each group to
    the query-head count (``jnp.repeat``'s order); else (k, v)."""
    H, KV = q.shape[2], k.shape[2]
    if not GQA_EXPAND or H == KV:
        return k, v
    rep = H // KV
    return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)


def q_heads(cfg, tp) -> Tuple[int, int]:
    """(first, count) of the query heads a rank computes: all of them
    unless `tp` cuts ``heads``."""
    split = cut(tp, "heads")
    if split is None:
        return 0, cfg.num_heads
    n = cfg.num_heads // split.size
    return split.index * n, n


def kv_for_heads(k: torch.Tensor, v: torch.Tensor, cfg, tp
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V (B,S,KV,hd) as the rank's query heads meet them: the key head
    of query head h is ``h // (H / KV)``.  Whole heads, or heads and key
    heads cut alike, pair as they are; where the query heads are cut and
    the key heads are not, a rank takes the key heads of its query heads
    -- a slice where each of them serves as many of its query heads
    (GQA over the slice), else one key head per query head (a group the
    cut splits, e.g. 40 / 10 heads over 4 ranks: the reference's
    ``maybe_expand_gqa`` for the rank's heads)."""
    if cut(tp, "heads") is None or cut(tp, "kv_heads") is not None:
        return k, v
    first, n = q_heads(cfg, tp)
    rep = cfg.num_heads // cfg.num_kv_heads
    lo, hi = first // rep, (first + n - 1) // rep + 1
    served = {min(first + n, (j + 1) * rep) - max(first, j * rep)
              for j in range(lo, hi)}
    if len(served) == 1:
        if (lo, hi) == (0, k.shape[2]):
            return k, v
        return (k[:, :, lo:hi].contiguous(), v[:, :, lo:hi].contiguous())
    idx = torch.arange(first, first + n, device=k.device) // rep
    return k.index_select(2, idx), v.index_select(2, idx)


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: int = 0,
                   q_offset: int = 0) -> torch.Tensor:
    """Exact chunked attention.  q (B,Sq,H,hd), k/v (B,Sk,KV,hd).

    Query chunking keeps the live score block at (Cq x Sk) instead of
    (Sq x Sk); with SWA the key block is additionally sliced to
    (window + Cq).
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    dev = q.device

    def mask_for(qpos, kpos):
        m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                       device=dev)
        if causal:
            m &= kpos[None, :] <= qpos[:, None]
        if window:
            m &= kpos[None, :] > qpos[:, None] - window
        return m

    if Sq < CHUNK_THRESHOLD or Sq % QUERY_CHUNK != 0:
        qpos = torch.arange(Sq, device=dev) + q_offset
        kpos = torch.arange(Sk, device=dev)
        mask = mask_for(qpos, kpos) if (causal or window) else None
        return _sdpa_block(qg, k, v, mask, scale).reshape(B, Sq, H, hd)

    # ---- chunked path (S >= CHUNK_THRESHOLD) ----
    use_window = window and window + QUERY_CHUNK < Sk
    outs = []
    for c in range(Sq // QUERY_CHUNK):
        q_chunk = qg[:, c * QUERY_CHUNK:(c + 1) * QUERY_CHUNK]
        qpos = c * QUERY_CHUNK + torch.arange(QUERY_CHUNK, device=dev) + q_offset
        if use_window:
            blk = window + QUERY_CHUNK
            start = min(max(c * QUERY_CHUNK + q_offset - window, 0), Sk - blk)
            kb, vb = k[:, start:start + blk], v[:, start:start + blk]
            kpos = start + torch.arange(blk, device=dev)
        else:
            kb, vb = k, v
            kpos = torch.arange(Sk, device=dev)
        m = mask_for(qpos, kpos) if (causal or window) else None
        outs.append(_sdpa_block(q_chunk, kb, vb, m, scale))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: int = 0,
              use_kernels: bool = False) -> torch.Tensor:
    """Attention over a whole sequence (training, prefill): with
    ``use_kernels`` through the flash-attention kernel, which computes
    the same function (``ops.attention``), else ``self_attention``."""
    if use_kernels:
        from repro_torch.kernels import ops
        return ops.attention(q, k, v, causal=causal, window=window)
    return self_attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """One query per sequence against a cache: q (B,1,H,hd), k/v
    (B,S_c,KV,hd), valid (S_c,) bool -> (B, H*hd); scores and softmax in
    f32, as the reference's decode."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) / math.sqrt(hd)
    scores = torch.where(valid, scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bgrqk,bkgd->bqgrd", probs, v).reshape(B, H * hd)


def embed(table: torch.Tensor, tokens: torch.Tensor, split,
          dtype) -> torch.Tensor:
    """The token embeddings in `dtype` (gather, then cast: the same values
    as casting the whole table).  Over a vocab `split` a rank holds the
    table's rows of its block: it looks up the tokens that fall there,
    zeros the others and the ranks' lookups are summed (each token's row
    comes from one rank, so the f32 sum is exact)."""
    if split is None:
        return table[tokens].to(dtype)
    n = table.shape[0]
    local = tokens - split.index * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].float()
    part = torch.where(inside[..., None], rows, 0.0)
    return row_sum(part, split).to(dtype)


def head(params, x: torch.Tensor, cfg, split=None) -> torch.Tensor:
    """Logits over the padded vocab: x times the tied embedding, or the
    untied ``lm_head``, the padding columns masked; over a vocab `split`
    a rank's block of the columns."""
    if cfg.tie_embeddings:
        w = params["embed"]["tok"].to(x.dtype).T
    else:
        w = params["lm_head"].to(x.dtype)
    offset = split.index * w.shape[-1] if split is not None else 0
    return mask_padded_vocab(column_input(x, split) @ w, cfg, offset)


def mask_padded_vocab(logits: torch.Tensor, cfg,
                      offset: int = 0) -> torch.Tensor:
    """-1e30 out the vocab-padding columns (see ModelConfig.padded_vocab);
    `logits` the columns from `offset` on (a rank's block of the vocab)."""
    start = max(cfg.vocab_size - offset, 0)
    if start >= logits.shape[-1]:
        return logits
    out = logits.clone()
    # fill_, not a scalar assignment: that one takes another op on the
    # meta device than on a card, and the dry run's trace follows the card
    out[..., start:].fill_(-1e30)
    return out


def greedy(logits: torch.Tensor, split=None) -> torch.Tensor:
    """Greedy tokens (B,) int32 from logits (B, V): the lowest index of
    the largest logit, as ``jnp.argmax``.  Over a vocab `split` each rank
    offers its block's best (value, global index) and the ranks' offers
    are compared whole: the largest value, the lowest index among ties."""
    idx = torch.argmax(logits, dim=-1)
    if split is None:
        return idx.to(torch.int32)
    val = logits.gather(-1, idx[:, None])[:, 0].float()
    group = _group(split)
    vals = torch.stack(group.all_gather(val))
    idxs = torch.stack(group.all_gather(
        idx + split.index * logits.shape[-1]))
    best = vals.max(dim=0).values
    tied = torch.where(vals == best, idxs, torch.iinfo(idxs.dtype).max)
    return tied.min(dim=0).values.to(torch.int32)


# ======================================================================
# loss
# ======================================================================
def _xent_nll(logits: torch.Tensor, targets: torch.Tensor,
              split=None) -> torch.Tensor:
    """Per-token NLL.  The label logit is picked with the reference's
    compare-select-reduce (iota == target, where, sum), not a gather: its
    backward stays an elementwise op, deterministic on CUDA without a
    scatter-add.  Over a vocab `split` (`logits` a rank's block of the
    columns) the f32 max is reduced over the ranks first, then the sum of
    exp and the target logit together, in one all-reduce: the reference's
    ``logsumexp`` - target, its backward by autograd as the reference's is
    by autodiff (``g / sum · exp(logit - max)``, less g at the target)."""
    lg = logits.float()
    iota = torch.arange(lg.shape[-1], device=lg.device)
    if split is None:
        lse = torch.logsumexp(lg, dim=-1)                        # (B,S)
        sel = torch.where(iota == targets[..., None], lg, 0.0)
        return lse - sel.sum(dim=-1)
    from repro_torch.distributed import AllReduce
    group = _group(split)
    hit = iota + split.index * lg.shape[-1] == targets[..., None]
    mx = group.all_reduce(lg.detach().amax(dim=-1, keepdim=True), "max")
    se, sel = AllReduce.apply(torch.stack([
        torch.exp(lg - mx).sum(dim=-1),
        torch.where(hit, lg, 0.0).sum(dim=-1)]), group)
    return torch.log(se) + mx[..., 0] - sel


def next_token_loss(logits: torch.Tensor, batch, split=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-length next-token loss and its token count: targets are the
    tokens rolled by one, the last position masked (S stays whole, as in
    the reference), times the batch's ``loss_mask`` where it has one."""
    tokens = batch["tokens"]
    targets = torch.roll(tokens, -1, dims=1)
    mask = batch.get("loss_mask")
    mask = (torch.ones(tokens.shape, dtype=torch.float32,
                       device=tokens.device) if mask is None
            else mask.float().clone())
    mask[:, -1].fill_(0.0)             # fill_: see mask_padded_vocab
    return softmax_xent_sharded(logits, targets, mask, split)


def softmax_xent_sharded(logits: torch.Tensor, targets: torch.Tensor,
                         mask: Optional[torch.Tensor] = None, split=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean cross-entropy and the token count; sequence-chunked
    when ``XENT_SEQ_CHUNK`` divides S, so at most (B, chunk, V) f32
    intermediates are live at once.  `split`: the logits are a rank's
    block of the vocab (:func:`_xent_nll`)."""
    S = logits.shape[1]
    C = XENT_SEQ_CHUNK
    if C and S > C and S % C == 0:
        nll = torch.cat([_xent_nll(logits[:, i:i + C], targets[:, i:i + C],
                                   split) for i in range(0, S, C)], dim=1)
    else:
        nll = _xent_nll(logits, targets, split)
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    mask = mask.float()
    ntok = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / ntok, ntok


# ======================================================================
# MLP (SwiGLU)
# ======================================================================
def mlp_specs(d: int, ff: int) -> Dict[str, ParamSpec]:
    return {
        "w_gate": ParamSpec((d, ff), ("d_model", "d_ff")),
        "w_up": ParamSpec((d, ff), ("d_model", "d_ff")),
        "w_down": ParamSpec((ff, d), ("d_ff", "d_model")),
    }


def mlp(params, x) -> torch.Tensor:
    """The SwiGLU MLP of the weights given, on `x` or on the two views
    (the gate's, the up's) that :func:`column_input` gives: over a
    ``d_ff`` split, a rank's columns of ``w_gate`` / ``w_up`` and rows of
    ``w_down`` give its partial output (:func:`row_sum` adds the
    ranks')."""
    xg, xu = x if isinstance(x, tuple) else (x, x)
    dt = xg.dtype
    g = xg @ params["w_gate"].to(dt)
    u = xu @ params["w_up"].to(dt)
    return (F.silu(g) * u) @ params["w_down"].to(dt)
