"""Deployment layer: exported serving artifacts and an HTTP endpoint.

Counterpart of ``ssip_tpu/deploy/``: a calibrated pipeline run becomes a
self-contained serving artifact (the classifier forward as a ``torch.export``
program with a symbolic batch, its weights and the operating point in one
``.ssip.npz``), loadable with torch, numpy and the port's operator modules,
and a stdlib HTTP server serves it.

    python -m ssip_tpu_torch.cli.export_model --output-dir outputs --model semi
    python -m ssip_tpu_torch.cli.serve --model-file outputs/models/semi_serving.ssip.npz
"""

from ssip_tpu_torch.deploy.export import ExportedModel, export_serving_artifact  # noqa: F401
from ssip_tpu_torch.deploy.server import make_server  # noqa: F401
