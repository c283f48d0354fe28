"""Fixed-batch-size inference with ragged-request padding.

Counterpart of ``sfc_vit_tpu/serving.py::ServingEngine`` for native
weights on one device.  The JAX engine compiles one executable per batch
size ahead of time; here PyTorch runs eagerly, so each batch size is run
once at build (warm-up: the kernels are built and loaded, allocator
pools are sized) and requests then go through the same fixed shapes.
A ragged request is cut into chunks of the largest batch size, and its
tail is padded with zero images up to the smallest batch size that covers
it; pad rows are dropped from the output.

Not ported yet (ROADMAP.md queue 1 item 12): int8 weights,
``export_serialized``, ``data_parallel`` and ``compile_cache``.  A model
over the ``'random'`` curve is refused: it draws a fresh token permutation
per step, and JAX's engine passes no ``'permute'`` stream to draw it from.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["ServingEngine"]


class ServingEngine:
    """Inference over a fixed set of batch sizes.

    Args:
      model: a module whose ``forward`` maps NHWC images to logits
        (``SimpleViT``, ``CurveViT``).
      state: a ``state_dict`` to load into ``model`` (for example from
        ``utils.load_flax_params(...).state_dict()``), or None to serve the
        module's weights as they are.
      image_shape: per-image ``(H, W, C)``.
      batch_sizes: the batch shapes to run; each is warmed up at build.
      dtype: cast floating parameters and inputs to this dtype (use
        ``torch.bfloat16`` on the GPU); None keeps them as they are.
      device: where the model runs.  On ``'cuda'`` every encoder block
        goes through the hand-written kernels.
    """

    def __init__(
        self,
        model: nn.Module,
        state: Optional[dict],
        image_shape: Tuple[int, int, int],
        batch_sizes: Sequence[int] = (256,),
        dtype: Optional[torch.dtype] = None,
        device="cuda",
    ):
        if not batch_sizes:
            raise ValueError("need at least one batch size to run")
        if any(getattr(m, "curve", None) == "random" for m in model.modules()):
            raise ValueError(
                "ServingEngine does not serve a curve='random' model: its tokens "
                "take a fresh permutation per step, and serving draws none (JAX's "
                "engine passes no 'permute' stream either)")
        self.device = torch.device(device)
        self.image_shape = tuple(image_shape)
        self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        self.dtype = dtype
        if state is not None:
            model.load_state_dict(state)
        self.model = model.to(device=self.device, dtype=dtype).eval()
        out = None
        for bs in self.batch_sizes:
            out = self._run(np.zeros((bs, *self.image_shape), np.float32))
        self._out_tail = out.shape[1:]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def weight_bytes(self) -> int:
        """Resident parameter memory."""
        return sum(p.numel() * p.element_size() for p in self.model.parameters())

    def _covering_bs(self, n: int) -> int:
        for bs in self.batch_sizes:
            if bs >= n:
                return bs
        return self.batch_sizes[-1]

    def _run(self, chunk: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(chunk).to(self.device, self.dtype or torch.float32)
        with torch.inference_mode():
            return self.model(x).float().cpu().numpy()

    def predict(self, images) -> np.ndarray:
        """Float32 logits for ``images`` ``[N, H, W, C]`` (any N >= 0).

        Full chunks run at the largest batch size; the ragged tail pads to
        the smallest covering batch size and the pad rows are dropped.
        The request stays on the host and goes to the device one chunk at
        a time.
        """
        x = np.asarray(images, np.float32)
        if x.ndim == len(self.image_shape):  # single image
            x = x[None]
        if x.shape[1:] != self.image_shape:
            raise ValueError(f"expected images of shape {self.image_shape}, "
                             f"got {x.shape[1:]}")
        n = x.shape[0]
        if n == 0:
            return np.zeros((0, *self._out_tail), np.float32)
        big = self.batch_sizes[-1]
        outs = []
        i = 0
        while n - i >= big:
            outs.append(self._run(x[i:i + big]))
            i += big
        if i < n:
            rem = n - i
            tail = np.zeros((self._covering_bs(rem), *self.image_shape), np.float32)
            tail[:rem] = x[i:]
            outs.append(self._run(tail)[:rem])
        return np.concatenate(outs, axis=0)

    def predict_classes(self, images) -> np.ndarray:
        return np.argmax(self.predict(images), axis=-1)
