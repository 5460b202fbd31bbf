"""ssip_tpu_torch — the PyTorch/CUDA port of ``ssip_tpu`` for NVIDIA Hopper.

A second package beside the JAX reference ``ssip_tpu/``, which stays as it
is and is what every module here is tested against. The port covers two
slices today:

- extraction: uint8 JPEG corpus → fused resize/crop/normalize (a
  hand-written CUDA kernel, ``ops/preproc.py`` + ``csrc/preproc.cu``) →
  frozen ResNet eval forward → 512-D embeddings and the ``outputs/features``
  artifact set (``pipelines/extraction.py``, CLI
  ``python -m ssip_tpu_torch.cli.feature_extraction``);
- supervised training: device-resident resized images → fused flip/rotate/
  normalize (a hand-written CUDA kernel, ``ops/rotate.py`` +
  ``csrc/augment.cu``) → train-mode ResNet with masked BatchNorm → masked
  cross-entropy → AdamW, under the reference's epoch driver
  (``train/engine.py``, ``pipelines/supervised.py``, CLI
  ``python -m ssip_tpu_torch.cli.supervised_training``).

Nothing here imports jax, flax, optax, scikit-learn or pandas; the only
``ssip_tpu`` modules used are the jax-free ``data.discovery``,
``runtime.artifacts``, ``runtime.logging``, ``pipelines.train_config`` and
``ops.thresholds``. CUDA kernels are compiled on first use
(``kernels/build.py``), so importing the package needs no compiler.
"""

__version__ = "0.1.0"
