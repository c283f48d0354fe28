"""The port's ServingEngine on the CPU, and the port's import surface."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sfc_vit_tpu_torch.models import CurveViT
from sfc_vit_tpu_torch.serving import ServingEngine

SMALL = dict(image_size=28, patch_size=4, dim=128, depth=2, heads=2,
             dim_head=64, mlp_dim=256, num_classes=10)


@pytest.fixture(scope="module")
def engine_and_model():
    model = CurveViT(**SMALL, generator=torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    engine = ServingEngine(CurveViT(**SMALL), state, (28, 28, 3),
                           batch_sizes=(8, 4), device="cpu")
    return engine, model


@pytest.mark.parametrize("n", [0, 1, 5, 9])
def test_ragged_requests_match_unpadded_forward(engine_and_model, n):
    engine, model = engine_and_model
    x = np.random.default_rng(n).standard_normal((n, 28, 28, 3)).astype(np.float32)
    got = engine.predict(x)
    assert got.shape == (n, 10) and got.dtype == np.float32
    if n:
        with torch.no_grad():
            want = model(torch.from_numpy(x)).numpy()
        # padding only adds rows; per-image results are row-local
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_engine_surface(engine_and_model):
    engine, model = engine_and_model
    assert engine.batch_sizes == (4, 8)
    x = np.random.default_rng(7).standard_normal((28, 28, 3)).astype(np.float32)
    assert engine.predict(x).shape == (1, 10)  # a single image
    assert engine.predict_classes(x[None]).shape == (1,)
    n_params = sum(p.numel() for p in model.parameters())
    assert engine.weight_bytes() == 4 * n_params
    with pytest.raises(ValueError, match="expected images of shape"):
        engine.predict(np.zeros((2, 32, 32, 3), np.float32))
    with pytest.raises(ValueError, match="batch size"):
        ServingEngine(model, None, (28, 28, 3), batch_sizes=(), device="cpu")


def test_engine_casts_to_dtype():
    engine = ServingEngine(CurveViT(**SMALL), None, (28, 28, 3),
                           batch_sizes=(2,), dtype=torch.bfloat16, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in engine.model.parameters())
    out = engine.predict(np.ones((3, 28, 28, 3), np.float32))
    assert out.shape == (3, 10) and np.isfinite(out).all()


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import sfc_vit_tpu_torch, sfc_vit_tpu_torch.models, "
        "sfc_vit_tpu_torch.ops, sfc_vit_tpu_torch.registry, "
        "sfc_vit_tpu_torch.serving, sfc_vit_tpu_torch.tokenizers, "
        "sfc_vit_tpu_torch.utils\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'jaxlib'))\n"
        "assert not bad, bad\n"
    )
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
