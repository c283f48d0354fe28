"""sfc_vit_tpu_torch: the PyTorch + CUDA port of ``sfc_vit_tpu`` for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``sfc_vit_tpu`` is the reference; this package mirrors its
module names.  It imports torch, never jax or flax, and nothing of the
JAX package: its own copy of the numpy-only curve layer (``curves``)
supplies the curve LUTs.

* ``curves``      -- curve generators and the static LUTs
* ``ops``         -- hand-written CUDA kernels (built with nvcc at first
                     use) beside their plain PyTorch versions, and the
                     attention dispatch
* ``tokenizers``  -- NHWC patchify, the static curve gather and the
                     hierarchical curve tokenizer
* ``models``      -- the pre-norm family (``SimpleViT``, ``CurveViT``) and
                     family A's ``VisionTransformer1D``
* ``registry``    -- ``ModelConfig``, ``PRESETS``, ``build_tokenizer``,
                     ``build_model``
* ``serving``     -- fixed-batch-size inference with ragged padding
* ``training``    -- losses, mixup/cutmix, schedules, the train and eval
                     steps (clip + AdamW) and a one-device ``Trainer``
* ``data``        -- in-memory datasets, the epoch plan, eval transforms
* ``utils``       -- flax param tree <-> module conversion, and gradients
                     onto the flax tree
"""

__version__ = "0.1.0"
