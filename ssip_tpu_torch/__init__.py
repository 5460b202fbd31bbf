"""ssip_tpu_torch — the PyTorch/CUDA port of ``ssip_tpu`` for NVIDIA Hopper.

A second package beside the JAX reference ``ssip_tpu/``, which stays as it
is and is what every module here is tested against. The port covers two
slices today, for the ResNet family, the dense ViT family and the MoE ViTs
(``models/moe.py``):

- extraction: uint8 JPEG corpus → fused resize/crop/normalize (a
  hand-written CUDA kernel, ``ops/preproc.py`` + ``csrc/preproc.cu``) →
  frozen ``--arch`` eval forward (ResNet-18/34/50, ViT-T/S/B/16, MoE
  ViT-T/S/16) → embeddings and the ``outputs/features`` artifact set
  (``pipelines/extraction.py``, CLI
  ``python -m ssip_tpu_torch.cli.feature_extraction``), resident, per batch
  or streamed, the streamed shape also with the host's resize on the native
  JPEG decoder (``native/``, built with g++ at first use);
- supervised training: device-resident resized images → fused flip/rotate/
  normalize (a hand-written CUDA kernel, ``ops/rotate.py`` +
  ``csrc/rotation.cu``) → train-mode forward (a ResNet with masked
  BatchNorm, or a ViT) → masked cross-entropy → AdamW, under the
  reference's epoch loop (``train/engine.py``, ``pipelines/supervised.py``,
  CLI ``python -m ssip_tpu_torch.cli.supervised_training``), with resume
  snapshots (``train/checkpoints.py``).

The ViT's LayerNorm and packed-qkv attention are hand-written CUDA kernels
too, forward and backward (``ops/layernorm.py`` + ``csrc/layernorm.cu``,
``ops/attention.py`` + ``csrc/attention.cu``, model ``models/vit.py``).

Around them, the workflow's other stages: the semi-supervised pipeline
(``pipelines/semi_supervised.py``), the threshold sweep
(``pipelines/sweep.py``), the dataset audit (``analysis/audit.py``) and the
analysis stack (``analysis/``: standardize, PCA, k-means, DBSCAN, t-SNE,
UMAP, the clustering metrics and orchestration; plain PyTorch ops), each
with the CLI of ``src/`` of the same name under ``cli/``; and deployment:
the screening predictor (``serving.py``), the ``torch.export`` serving
artifact and its HTTP server (``deploy/``), the ResNets' BN fold and int8
post-training quantization (``models/inference.py``,
``models/quantized.py``), with the CLIs ``predict``, ``export_model`` and
``serve``.

Nothing here imports jax, flax, optax or scikit-learn, and nothing of the
JAX package: the jax-free modules the port needs from it
(``data/discovery.py``, ``runtime/artifacts.py``, ``runtime/logging.py``,
``pipelines/train_config.py``, ``ops/thresholds.py``,
``analysis/audit.py``, ``analysis/audit_contract.py``,
``analysis/blocked.py``) are the port's own copies. pandas is imported by
the audit alone, and matplotlib only by the functions that draw
(``report/``). CUDA kernels are compiled on first use
(``kernels/build.py``), and so is the native decoder (``native/build.py``),
so importing the package needs no compiler.
"""

__version__ = "0.1.0"
