"""Family-A building blocks (torch-style semantics) in PyTorch.

Counterpart of ``sfc_vit_tpu/models/layers.py``: the post-norm torch
``nn.TransformerEncoderLayer`` stack (relu, LayerNorm eps 1e-5), the
channel-mix-only ``MixerBlock``, the Kronecker-factorised head and the
``TokenAggregator``.  Parameter names follow the flax tree
(``self_attn/{in_proj,out_proj}``, ``norm1``, ``linear1``, ``linear2``,
``norm2``, ``channel_mix_*``, ``fact/{W_emb,W_seq}``, ...) and every Dense
kernel is kept ``[in, out]``, so ``utils.convert`` maps one onto the
other without a transpose.

``dtype`` is the compute dtype, as in flax: ``None`` promotes the input
with the float32 parameters (so a bf16 input computes in fp32), a dtype
casts inputs and parameters to it.

Every layer routes as the JAX module routes on its chip
(:func:`family_a_route`: :func:`mha_route` for the attention,
:func:`tail_route` for what follows it).

Dropout is flax's: a keep mask bernoulli(1 - rate), then
``where(mask, x / keep, 0)`` (dividing by keep, never multiplying by its
reciprocal).  It is on only in ``module.training``.  Every mask comes
from :func:`dropout_mask`, which draws from the generator installed by
:func:`dropout_generator` (the train step installs one on the model's
device) or, with none installed, from PyTorch's default generator of the
device; one function, so a test can replay another framework's masks in
draw order.

``remat`` (flax's ``nn.remat``) recomputes each checkpointed layer's
activations in the backward (:func:`remat_call`), replaying the dropout
generator, so that the recompute draws the masks the forward drew.

The ``'random'`` curve's per-call token permutation (flax's
``make_rng('permute')``) is drawn the same way: :func:`curve_permutation`
takes it from the generator :func:`permutation_generator` installs, once
per installation, through the one draw function :func:`draw_permutation`.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.attention import packed_qkv_attention
from ..ops.fused_mlp import fused_postnorm_tail
from ..ops.fused_torch_attention import fused_torch_mha, torch_mha_train
from ..ops.kernel_utils import ln_fp32
from ..utils.initializers import lecun_normal, xavier_normal

__all__ = [
    "Dense",
    "LayerNorm",
    "dropout",
    "dropout_generator",
    "dropout_mask",
    "remat_call",
    "permutation_generator",
    "curve_permutation",
    "draw_permutation",
    "TokenAggregator",
    "TorchMultiHeadAttention",
    "TorchTransformerEncoderLayer",
    "TransformerSeqEncoder",
    "MixerBlock",
    "FactorisedLinear",
    "MultiLayerPredictor",
    "TORCH_MHA_MAX_N",
    "POSTNORM_TAIL_MIN_F",
    "mha_route",
    "tail_route",
    "family_a_route",
]

#: JAX's length limit for the fused torch-MHA training kernels #5/#6:
#: ``torch_mha_fits`` and ``torch_mha_bwd_fits`` return False past it
#: before any VMEM budget (``sfc_vit_tpu/ops/fused_torch_attention.py:161,
#: 433``: one whole-sequence softmax per image), so JAX trains longer
#: sequences through the explicit-weights formula ``torch_mha_train``.  It
#: picks the formula (the kernel rounds each projection once, the formula
#: rounds the product before adding the bias), so the port keeps it.
TORCH_MHA_MAX_N = 1024

#: JAX's width gate for the post-norm tail kernels #15/#16
#: (``sfc_vit_tpu/models/layers.py:237-243``): the MLP width from which
#: the tail is fused.
POSTNORM_TAIL_MIN_F = 1024


def mha_route(attn_impl: str, n: int, d: int, dropout_rate: float,
              training: bool) -> str:
    """The attention path of a family-A layer: ``'fused_mha'`` (#5/#6,
    training with dropout below :data:`TORCH_MHA_MAX_N` tokens, JAX's
    ``mha_train_pallas`` on its chip without the VMEM budget),
    ``'mha_train'`` (the explicit-weights formula: other training with
    dropout, and rate 1) or ``'packed'`` (eval, or no dropout: the
    projections around ``packed_qkv_attention``)."""
    if not (dropout_rate > 0.0 and training):
        return "packed"
    fused = (dropout_rate < 1.0 and attn_impl == "auto" and d % 128 == 0
             and n <= TORCH_MHA_MAX_N)
    return "fused_mha" if fused else "mha_train"


def tail_route(attn_impl: str, d: int, f: int, dropout_rate: float,
               training: bool) -> str:
    """The path after the attention: ``'postnorm_tail'`` (#15/#16) where
    JAX's gate takes it (``sfc_vit_tpu/models/layers.py:233-245``:
    ``attn_impl='auto'``, no active dropout, D and F multiples of 128,
    F >= 1024; without ``postnorm_tail_fits``, a VMEM budget), else
    ``'unfused'`` (the flax modules' formula)."""
    fused = (attn_impl == "auto" and not (dropout_rate > 0.0 and training)
             and d % 128 == 0 and f % 128 == 0 and f >= POSTNORM_TAIL_MIN_F)
    return "postnorm_tail" if fused else "unfused"


def family_a_route(attn_impl: str, n: int, d: int, heads: int, f: int,
                   dropout_rate: float, training: bool) -> Tuple[str, str]:
    """``(attention, tail)`` of a family-A encoder layer over ``n`` tokens
    of width ``d``, ``heads`` heads and MLP width ``f``: the
    :func:`mha_route` and the :func:`tail_route`, the gates the modules
    read.  ``heads`` is in JAX's gate (``mha_train_pallas``) only for its
    VMEM budget, which the port leaves out."""
    del heads
    return (mha_route(attn_impl, n, d, dropout_rate, training),
            tail_route(attn_impl, d, f, dropout_rate, training))


_GENERATOR: contextvars.ContextVar = contextvars.ContextVar(
    "dropout_generator", default=None)


@contextlib.contextmanager
def dropout_generator(generator: Optional[torch.Generator]):
    """Draw every dropout mask inside the block from ``generator`` (the
    counterpart of flax's ``rngs={'dropout': key}`` for one apply)."""
    token = _GENERATOR.set(generator)
    try:
        yield
    finally:
        _GENERATOR.reset(token)


def dropout_mask(shape, keep: float, device) -> torch.Tensor:
    """A bool keep mask of ``shape``: ``uniform < keep``, as
    ``jax.random.bernoulli`` draws it."""
    return torch.rand(tuple(shape), device=device, generator=_GENERATOR.get()) < keep


def remat_call(module: nn.Module, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``module(x)``; with ``remat``, in training under autograd, through
    ``torch.utils.checkpoint`` (non-reentrant, so the forward runs with grad
    on and the fused wrappers take their training forms both times): the
    module's activations are dropped after the forward and recomputed in
    the backward, flax's ``nn.remat``.

    flax's recompute replays the dropout key.  Here the recompute runs in
    the backward, outside the :func:`dropout_generator` block, so it is
    given a copy of the generator the forward found, set to the state the
    forward found it in: it draws the forward's masks, and the live
    generator stays where the forward left it for every later draw.  With
    no generator installed the masks come from the default generator, whose
    state ``checkpoint`` saves and restores itself."""
    if not (remat and module.training and torch.is_grad_enabled()):
        return module(x)
    gen = _GENERATOR.get()
    state = None if gen is None else gen.get_state()
    calls = 0

    def run(inp):
        nonlocal calls
        calls += 1
        if calls == 1:  # the forward, on the live generator
            return module(inp)
        replay = None
        if gen is not None:
            replay = torch.Generator(device=gen.device)
            replay.set_state(state)
        with dropout_generator(replay):
            return module(inp)

    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)


_PERMUTE: contextvars.ContextVar = contextvars.ContextVar(
    "permutation_generator", default=None)


@contextlib.contextmanager
def permutation_generator(generator: torch.Generator):
    """Draw the ``'random'`` curve's token permutation inside the block from
    ``generator``, once: every forward in the block gets the same one (the
    counterpart of flax's ``rngs={'permute': key}``: JAX's train step
    passes one ``k_perm`` to every micro-batch, its eval step the constant
    ``jax.random.key(0)``)."""
    token = _PERMUTE.set((generator, {}))
    try:
        yield
    finally:
        _PERMUTE.reset(token)


def draw_permutation(n: int, generator: torch.Generator) -> torch.Tensor:
    """A permutation of ``range(n)`` from ``generator`` (int64, on the
    generator's device): ``jax.random.permutation``'s counterpart, the
    numbers another stream's."""
    return torch.randperm(n, generator=generator, device=generator.device)


def curve_permutation(n: int, device) -> torch.Tensor:
    """The permutation of ``n`` tokens for this :func:`permutation_generator`
    block (int64, on ``device``): drawn by :func:`draw_permutation` the
    first time ``n`` is asked for in the block, the same one after.  Raises
    outside a block, as flax raises without a ``'permute'`` stream."""
    scope = _PERMUTE.get()
    if scope is None:
        raise RuntimeError(
            "curve='random' draws a fresh token permutation per step from the "
            "generator that models.layers.permutation_generator installs (the "
            "train and eval steps install one); none is installed here")
    generator, drawn = scope
    if n not in drawn:
        drawn[n] = draw_permutation(n, generator)
    return drawn[n].to(device)


def dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """flax ``nn.Dropout(rate)(x, deterministic=not training)``."""
    if rate == 0.0 or not training:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    return torch.where(dropout_mask(x.shape, keep, x.device), x / keep,
                       x.new_zeros(()))


def _compute_dtype(dtype: Optional[torch.dtype], x: torch.Tensor,
                   p: torch.Tensor) -> torch.dtype:
    return dtype or torch.promote_types(x.dtype, p.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` [in, out] (lecun normal) and a zero
    ``bias``; ``x @ kernel + bias`` in the compute dtype."""

    def __init__(self, in_dim: int, features: int,
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal(in_dim, features, generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.kernel)
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-5)``: fp32 statistics (the clamped
    fast-variance form of :func:`~sfc_vit_tpu_torch.ops.ln_fp32`), the
    result in the compute dtype."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.scale)
        return ln_fp32(x.float(), self.scale, self.bias, 1e-5).to(dt)


class TokenAggregator(nn.Module):
    """Depthwise-separable Conv1d over the token axis, then GELU and
    LayerNorm (the reference's ``vit.py:20-42``; opt-in).  The kernels
    keep flax's layout: ``dw`` [k, 1, D], ``pw`` [1, D, D]."""

    def __init__(self, dim: int, kernel: int = 3, stride: int = 1,
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.dw = nn.Module()
        self.dw.kernel = nn.Parameter(lecun_normal(kernel, dim, generator)[:, None, :])
        self.dw.bias = nn.Parameter(torch.zeros(dim))
        self.pw = nn.Module()
        self.pw.kernel = nn.Parameter(lecun_normal(dim, dim, generator)[None])
        self.pw.bias = nn.Parameter(torch.zeros(dim))
        self.norm = LayerNorm(dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, N, D]
        dt = _compute_dtype(self.dtype, x, self.dw.kernel)
        k = self.dw.kernel.shape[0]
        w = self.dw.kernel.to(dt).permute(2, 1, 0)  # [D, 1, k]
        x = F.conv1d(x.to(dt).transpose(1, 2), w, self.dw.bias.to(dt),
                     stride=self.stride, padding=k // 2, groups=w.shape[0])
        x = x.transpose(1, 2) @ self.pw.kernel[0].to(dt) + self.pw.bias.to(dt)
        return self.norm(F.gelu(x))


class TorchMultiHeadAttention(nn.Module):
    """Packed-QKV multi-head self-attention with torch
    ``nn.MultiheadAttention``'s parameterisation (``in_proj`` [D, 3D] and
    ``out_proj``, each ``{kernel, bias}``) and its training semantics:
    dropout on the attention probabilities.

    Three branches, as in the JAX module, picked by :func:`mha_route`:
    under training with ``0 < rate < 1``, ``attn_impl='auto'``,
    ``D % 128 == 0`` and at most :data:`TORCH_MHA_MAX_N` tokens, the fused
    :func:`~sfc_vit_tpu_torch.ops.fused_torch_mha` (kernels #5 and #6 on
    the card); other training with dropout, the explicit-weights formula
    :func:`~sfc_vit_tpu_torch.ops.fused_torch_attention.torch_mha_train`;
    otherwise (eval, serving) the projections around
    :func:`~sfc_vit_tpu_torch.ops.attention.packed_qkv_attention` (kernel
    #7 on the card).
    """

    def __init__(self, dim: int, n_heads: int, dropout_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None, attn_impl: str = "auto",
                 generator=None):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"dim {dim} not divisible by heads {n_heads}")
        self.dim, self.n_heads = dim, n_heads
        self.dropout_rate, self.dtype, self.attn_impl = dropout_rate, dtype, attn_impl
        self.in_proj = Dense(dim, 3 * dim, generator=generator)
        self.out_proj = Dense(dim, dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, heads = self.dim, self.n_heads
        dt = _compute_dtype(self.dtype, x, self.in_proj.kernel)
        xc = x.to(dt)
        w_in, b_in, w_out, b_out = (t.to(dt) for t in (
            self.in_proj.kernel, self.in_proj.bias, self.out_proj.kernel,
            self.out_proj.bias))
        b, n, _ = x.shape
        rate = self.dropout_rate
        route = mha_route(self.attn_impl, n, d, rate, self.training)
        if route != "packed":
            if rate == 1.0:  # flax's Dropout(1.0): every weight zeroed, no draw
                mask, keep = torch.zeros((b, heads, n, n), dtype=torch.bool,
                                         device=x.device), 1.0
            else:
                keep = 1.0 - rate
                mask = dropout_mask((b, heads, n, n), keep, x.device)
            mha = fused_torch_mha if route == "fused_mha" else torch_mha_train
            return mha(xc, w_in, b_in, w_out, b_out, mask, heads, keep=keep)
        out = packed_qkv_attention(xc @ w_in + b_in, heads,
                                   implementation=self.attn_impl)
        return out @ w_out + b_out


class TorchTransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer with torch ``nn.TransformerEncoderLayer``'s
    defaults (relu, dropout 0.1, LayerNorm eps 1e-5):
        x = norm1(x + Dropout(SelfAttn(x)))
        x = norm2(x + Dropout(Linear2(Dropout(relu(Linear1(x))))))

    Everything after the attention goes through
    :func:`~sfc_vit_tpu_torch.ops.fused_postnorm_tail` (#15, and #16 under
    autograd, on the card; their plain versions on the CPU) where
    :func:`tail_route` says so, as the JAX module does: ``attn_impl='auto'``,
    dropout off, D and f multiples of 128 and ``f >= 1024``.  Otherwise the
    unfused formula below.  The parameters are the same either way.
    """

    def __init__(self, dim: int, n_heads: int, hidden_dim: int,
                 dropout_rate: float = 0.1, dtype: Optional[torch.dtype] = None,
                 attn_impl: str = "auto", generator=None):
        super().__init__()
        self.dropout_rate, self.dtype, self.attn_impl = dropout_rate, dtype, attn_impl
        self.self_attn = TorchMultiHeadAttention(dim, n_heads, dropout_rate,
                                                 dtype, attn_impl, generator)
        self.norm1 = LayerNorm(dim, dtype)
        self.linear1 = Dense(dim, hidden_dim, dtype, generator)
        self.linear2 = Dense(hidden_dim, dim, dtype, generator)
        self.norm2 = LayerNorm(dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rate = self.dropout_rate
        attn = dropout(self.self_attn(x), rate, self.training)
        d, f = self.linear1.kernel.shape
        if tail_route(self.attn_impl, d, f, rate, self.training) == "postnorm_tail":
            dt = _compute_dtype(self.dtype, x, self.linear1.kernel)
            w1, b1, w2, b2 = (t.to(dt) for t in (
                self.linear1.kernel, self.linear1.bias, self.linear2.kernel,
                self.linear2.bias))
            return fused_postnorm_tail(
                x.to(dt), attn.to(dt), self.norm1.scale, self.norm1.bias, w1, b1,
                w2, b2, self.norm2.scale, self.norm2.bias, eps=1e-5,
                activation="relu")
        x = self.norm1(x + attn)
        h = dropout(F.relu(self.linear1(x)), rate, self.training)
        h = dropout(self.linear2(h), rate, self.training)
        return self.norm2(x + h)


class TransformerSeqEncoder(nn.Module):
    """A stack of post-norm encoder layers ``layer_{i}`` (the reference's
    ``vit.py:177-242``; no CLS token, no positional encoding).  ``remat``
    checkpoints each layer whole in training (:func:`remat_call`), as JAX's
    ``nn.remat(TorchTransformerEncoderLayer)``."""

    def __init__(self, dim: int, n_heads: int, hidden_dim: int, n_layers: int = 1,
                 dropout_rate: float = 0.1, dtype: Optional[torch.dtype] = None,
                 attn_impl: str = "auto", generator=None, remat: bool = False):
        super().__init__()
        self.n_layers, self.remat = n_layers, remat
        for i in range(n_layers):
            self.add_module(f"layer_{i}", TorchTransformerEncoderLayer(
                dim, n_heads, hidden_dim, dropout_rate, dtype, attn_impl, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = remat_call(getattr(self, f"layer_{i}"), x, self.remat)
        return x


class MixerBlock(nn.Module):
    """MLP-Mixer block, channel-mix branch only: ``x + channel_mix(LN(x))``
    with an exact-erf GELU (the reference's token-mix branch is commented
    out).  ``out_dim`` must equal ``embed_dim`` (the residual)."""

    def __init__(self, seq_len: int, embed_dim: int, hidden_dim: int,
                 out_dim: Optional[int] = None, dtype: Optional[torch.dtype] = None,
                 generator=None):
        super().__init__()
        out_dim = embed_dim if out_dim is None else out_dim
        if out_dim != embed_dim:
            raise ValueError(f"MixerBlock residual requires out_dim == embed_dim "
                             f"({out_dim} != {embed_dim})")
        self.channel_mix_ln = LayerNorm(embed_dim, dtype)
        self.channel_mix_0 = Dense(embed_dim, hidden_dim, dtype, generator)
        self.channel_mix_1 = Dense(hidden_dim, out_dim, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.channel_mix_0(self.channel_mix_ln(x))
        return x + self.channel_mix_1(F.gelu(h))


class FactorisedLinear(nn.Module):
    """Kronecker-factorised head [B, N, D] -> [B, out]:
    ``einsum('bnr,onr->bo', einsum('bnd,rd->bnr', x, W_emb), W_seq)``,
    with flax's xavier-normal init (``W_seq`` with batch axis 0)."""

    def __init__(self, seq_len: int, embed_dim: int, rank: int, out_dim: int,
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__()
        self.W_emb = nn.Parameter(xavier_normal((rank, embed_dim), rank, embed_dim,
                                                generator))
        self.W_seq = nn.Parameter(xavier_normal((out_dim, seq_len, rank), seq_len,
                                                rank, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.einsum("bnd,rd->bnr", x, self.W_emb.to(x.dtype))
        return torch.einsum("bnr,onr->bo", h, self.W_seq.to(x.dtype))


class MultiLayerPredictor(nn.Module):
    """Classification head: LN (or MixerBlock) -> FactorisedLinear ->
    GELU -> Dropout -> [hidden Dense layers] -> Dense(num_classes)
    (the reference's ``vit.py:295-319``)."""

    def __init__(self, embed_dim: int, seq_len: int, n_layers: int = 2,
                 rank: int = 64, dropout_rate: float = 0.5, num_classes: int = 10,
                 mix: bool = False, dtype: Optional[torch.dtype] = None,
                 generator=None):
        super().__init__()
        self.mix, self.dropout_rate, self.n_hidden = mix, dropout_rate, n_layers - 2
        if mix:
            self.mixer = MixerBlock(seq_len, embed_dim, embed_dim * 2, dtype=dtype,
                                    generator=generator)
        else:
            self.norm = LayerNorm(embed_dim, dtype)
        self.fact = FactorisedLinear(seq_len, embed_dim, rank, embed_dim * 2, dtype,
                                     generator)
        prev = embed_dim * 2
        for i in range(self.n_hidden):
            self.add_module(f"hidden_{i}", Dense(prev, prev // 2, dtype, generator))
            prev //= 2
        self.out = Dense(prev, num_classes, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.mixer(x) if self.mix else self.norm(x)
        h = dropout(F.gelu(self.fact(x)), self.dropout_rate, self.training)
        for i in range(self.n_hidden):
            h = dropout(F.gelu(getattr(self, f"hidden_{i}")(h)), self.dropout_rate,
                        self.training)
        return self.out(h)
