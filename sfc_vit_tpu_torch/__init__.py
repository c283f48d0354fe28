"""sfc_vit_tpu_torch: the PyTorch + CUDA port of ``sfc_vit_tpu`` for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``sfc_vit_tpu`` is the reference; this package mirrors its
module names.  It imports torch and never jax or flax; the host-side,
numpy-only curve layer ``sfc_vit_tpu.curves`` supplies the curve LUTs.

* ``ops``         -- hand-written CUDA kernels (built with nvcc at first
                     use) beside their plain PyTorch versions
* ``tokenizers``  -- NHWC patchify and the static curve gather
* ``models``      -- the pre-norm family: ``SimpleViT``, ``CurveViT``
* ``registry``    -- ``ModelConfig``, ``PRESETS``, ``build_model``
* ``serving``     -- fixed-batch-size inference with ragged padding
* ``utils``       -- flax param tree <-> module conversion
"""

__version__ = "0.1.0"
