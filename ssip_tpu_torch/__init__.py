"""ssip_tpu_torch — the PyTorch/CUDA port of ``ssip_tpu`` for NVIDIA Hopper.

A second package beside the JAX reference ``ssip_tpu/``, which stays as it
is and is what every module here is tested against. The port covers two
slices today, for the ResNet family and the dense ViT family:

- extraction: uint8 JPEG corpus → fused resize/crop/normalize (a
  hand-written CUDA kernel, ``ops/preproc.py`` + ``csrc/preproc.cu``) →
  frozen ``--arch`` eval forward (ResNet-18/34/50, ViT-T/S/B/16) →
  embeddings and the ``outputs/features`` artifact set
  (``pipelines/extraction.py``, CLI
  ``python -m ssip_tpu_torch.cli.feature_extraction``);
- supervised training: device-resident resized images → fused flip/rotate/
  normalize (a hand-written CUDA kernel, ``ops/rotate.py`` +
  ``csrc/augment.cu``) → train-mode forward (a ResNet with masked
  BatchNorm, or a ViT) → masked cross-entropy → AdamW, under the
  reference's epoch loop (``train/engine.py``, ``pipelines/supervised.py``,
  CLI ``python -m ssip_tpu_torch.cli.supervised_training``).

The ViT's LayerNorm and packed-qkv attention are hand-written CUDA kernels
too, forward and backward (``ops/layernorm.py`` + ``csrc/layernorm.cu``,
``ops/attention.py`` + ``csrc/attention.cu``, model ``models/vit.py``).

Nothing here imports jax, flax, optax, scikit-learn or pandas, and nothing
of the JAX package: the jax-free modules the port needs from it
(``data/discovery.py``, ``runtime/artifacts.py``, ``runtime/logging.py``,
``pipelines/train_config.py``, ``ops/thresholds.py``) are the port's own
copies. CUDA kernels are compiled on first use
(``kernels/build.py``), so importing the package needs no compiler.
"""

__version__ = "0.1.0"
