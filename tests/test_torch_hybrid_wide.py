"""A small hybrid CurveViT at two heads of 128 against the JAX package on
the CPU: the hybrid preset's schedule ('local' layers beside a global one,
a token merge after the first) cut to size, its curve-local layers at head
dim 128, held against JAX's through the converter at ``dtype=None`` (fp32,
the JAX CLI's default, where #12/#13 run their fp32 forms on the card) and
in bf16.  The plain versions of those kernels at head dims 128 and 256:
``tests/test_torch_longctx_wide.py``.  Inputs come from
``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfc_vit_tpu.models import CurveViT as JCurveViT
from sfc_vit_tpu_torch.models import CurveViT
from sfc_vit_tpu_torch.ops import local_attention as la
from sfc_vit_tpu_torch.utils import load_flax_params, to_flax_grads


#: 20 x 20 pixels along the Hilbert curve: 400 tokens in 'local' layer 0,
#: 300 after the merge in 'local' layer 1 (three curve blocks of the merged
#: sequence, the last ragged), then a global 'auto' layer: the hybrid
#: preset's schedule cut to size, d = 256 as 2 heads of 128.
HYBRID_WIDE = dict(image_size=20, patch_size=1, num_classes=10, dim=256, depth=3, heads=2,
                   dim_head=128, mlp_dim=256, merge_layers=(0,), merge_ratio=0.5,
                   attn_impl=("local", "local", "auto"))
#: fp32: logits within this fraction of the largest |logit|, gradients
#: within this relative L2 error of each tensor; bf16: the flagship's gates
#: (each framework rounds at its own points).
F32_LOGIT, F32_GRAD = 1e-4, 1e-4
BF16_LOGIT, BF16_GRAD = 0.03, 0.1


def _rel_l2(got, want):
    w = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - w) / max(np.linalg.norm(w), 1e-30)


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["fp32", "bf16"])
def test_small_hybrid_curvevit_at_dim_head_128_matches_jax(dtype):
    """Logits and the gradients of ``sum(logits * w)`` against JAX's hybrid
    CurveViT from the same parameters (the converter), at ``dtype=None``
    within 1e-4 and in bf16 within the flagship's gates (JAX jitted: its
    fusions keep some intermediates in fp32 that the port rounds)."""
    jmodel = JCurveViT(**HYBRID_WIDE, dtype=getattr(jnp, dtype) if dtype else None)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 20, 20, 3)).astype(np.float32)
    w = rng.standard_normal((1, 10)).astype(np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)

    def loss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x))
        return (out.astype(jnp.float32) * w).sum(), out

    want_grads, want = jax.jit(jax.grad(loss, has_aux=True))(params)
    model = load_flax_params(
        CurveViT(**HYBRID_WIDE, dtype=getattr(torch, dtype) if dtype else None), params)
    assert not la.is_dense(300, 128, 1)
    got = model(torch.from_numpy(x))
    (got.float() * torch.from_numpy(w)).sum().backward()
    logit_tol, grad_tol = (BF16_LOGIT, BF16_GRAD) if dtype else (F32_LOGIT, F32_GRAD)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= logit_tol * float(np.abs(want).max()), err
    flat = dict(jax.tree_util.tree_leaves_with_path(to_flax_grads(model)))
    leaves = jax.tree_util.tree_leaves_with_path(want_grads)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        err = _rel_l2(flat[path], leaf)
        assert err <= grad_tol, (jax.tree_util.keystr(path), err)
