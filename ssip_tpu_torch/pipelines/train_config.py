"""Shared training configuration (mirrors reference TrainingConfig fields).

Field inventory parity: reference src/training/common.py:45-80 — same names,
same defaults — with artifact paths derived from ``output_dir`` through the
ArtifactRegistry instead of hard-coded strings.

The port's own copy of ``ssip_tpu/pipelines/train_config.py`` (the port
imports nothing of the JAX package): the same fields and defaults;
``build_mesh`` is the process group's mesh (``parallel/mesh.py``), and
``resume_path`` names the port's snapshot. Comments that name jax
mechanisms describe the JAX package's settings; the port refuses the ones
it lacks.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from ssip_tpu_torch.runtime.artifacts import ArtifactRegistry


@dataclass
class TrainingConfig:
    strong_data_dir: Path
    weak_data_dir: Optional[Path] = None
    # backbone architecture (models/registry.py key). The
    # reference hard-codes resnet18 (common.py:299-304); 34/50 are
    # TPU-native extras. Recorded in training_history.json and
    # operating_point.json so sweep/serving rebuild the right model.
    arch: str = "resnet18"
    batch_size: int = 16
    val_split: float = 0.2
    test_split: float = 0.2
    seed: int = 42
    image_size: int = 224
    num_workers: int = 2  # decode threads (kept for flag parity)
    device: str = "auto"
    positive_class: str = "cancer"
    target_recall: Optional[float] = None
    min_precision: Optional[float] = None
    max_fpr: Optional[float] = None
    f_beta: float = 2.0
    baseline_epochs: int = 10
    weak_pretrain_epochs: int = 5
    finetune_epochs: int = 8
    pseudo_label_threshold: float = 0.7
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    early_stopping_patience: int = 3
    # "float32" (reference parity) | "bfloat16" (throughput): activation
    # dtype for conv/matmul compute in train/eval forwards. Params, BN
    # statistics, logits, loss, grads and the optimizer stay f32 (the
    # mixed-precision convention models/resnet.py implements), so
    # checkpoints and the plateau/early-stop loop are unaffected.
    compute_dtype: str = "float32"
    output_dir: Path = Path("outputs")
    unlabeled_cohort_csv: Optional[Path] = None
    pretrained_weights: Optional[Path] = None  # torch resnet18 state_dict
    # FixMatch-style augmentation-consistency regularization (0 = off,
    # reference-equivalent behavior)
    consistency_weight: float = 0.0
    consistency_threshold: float = 0.95
    # strong view for the consistency loss: "jitter" (flip/rotate/
    # brightness/contrast) or "randaugment" (the FixMatch paper's
    # RandAugment+Cutout policy, ops/randaugment.py)
    strong_augment: str = "jitter"
    # Mean-Teacher EMA decay for the consistency phase's pseudo-target
    # teacher (0 = off: the teacher is the live student). 0.999 typical;
    # eval/best-state follow the EMA model when on (train/consistency.py).
    ema_decay: float = 0.0
    # mid-run resume: snapshot TrainState every epoch under
    # models/checkpoints/ and restore on restart (preemption-safe training)
    resume: bool = False
    # data-parallel degree: devices on the mesh's data axis for train/eval
    # steps (None = all local devices). Sync-BN over the global batch keeps
    # the trajectory device-count invariant.
    mesh_data: Optional[int] = None
    # tensor-parallel degree (mesh model axis): wide conv output channels
    # and the fc input axis shard over this many devices
    # (parallel.mesh.tp_param_spec). 1 = pure DP.
    mesh_model: int = 1
    # ZeRO-3-style fully-sharded data parallelism: parameters + optimizer
    # moments live sharded 1/N over the mesh data axis (big leaves only —
    # parallel.mesh.fsdp_param_spec); XLA all-gathers weights at use and
    # reduce-scatters gradients. Same trajectory as replicated DP to fp
    # tolerance; memory per device scales 1/N. Matters for the ViT family
    # (vit_b16: 86M params ×3 AdamW copies), inert at ResNet-18 scale.
    mesh_fsdp: bool = False
    # gradient checkpointing (jax.checkpoint / rematerialization) of the
    # ViT encoder blocks: activation memory O(layers) → O(1) blocks at
    # ~1/3 extra forward FLOPs. ViT-only (the ResNet blocks' masked-BN
    # kwargs don't thread through nn.remat); ignored for resnet archs.
    remat: bool = False
    # seed fan-out (TPU extra, train.multi_seed): train this many
    # independent models (seeds seed, seed+1, ...) simultaneously in one
    # vmapped program, seed axis sharded over the mesh data axis, and keep
    # the best-val-loss seed's model. 1 = reference behavior.
    num_seeds: int = 1
    # stratified k-fold cross-validation (TPU extra): before the main run,
    # train all K folds simultaneously (one vmapped lane per fold, test
    # split held out) and write per-fold + mean/std validation metrics to
    # tables/cv_results.csv. 0 = off (reference behavior).
    cv_folds: int = 0

    def build_mesh(self, device):
        """The training mesh over the process group (``mesh_data``
        processes on the data axis, default all), or None for a process
        that joined no group."""
        from ssip_tpu_torch.parallel.mesh import training_mesh

        return training_mesh(self.mesh_data, model=self.mesh_model, device_type=device.type)

    def resume_path(self, stream: str):
        """The stream's resume snapshot: the JAX package's directory and
        stream name, the port's own format and suffix
        (``train/checkpoints.py``; a directory with
        ``SSIP_SNAPSHOT_FORMAT=orbax``)."""
        if not self.resume:
            return None
        return self.artifacts.models_dir / "checkpoints" / f"{stream}.torchsnap"

    @property
    def artifacts(self) -> ArtifactRegistry:
        return ArtifactRegistry(Path(self.output_dir))
