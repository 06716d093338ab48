"""Dataset IO: g2o pose-graph files, synthetic benchmark generators,
checkpointing. The reference had no dataset path at all — its only input was
the live Stage simulator (SURVEY.md §2.2 'Stage' row); g2o replay is the
batch-testable equivalent."""

from graphslam.io.g2o import load_g2o, save_g2o  # noqa: F401
from graphslam.io import datasets  # noqa: F401
