"""Figures of the training runs (``plots.py``) and the analysis stage
(``cluster_plots.py``).

matplotlib is imported only when a figure is drawn (``pyplot``), so that
``import ssip_tpu_torch`` and the extraction and training paths run where it
is not installed.
"""


def pyplot():
    """matplotlib's pyplot on the Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
