from .knn import knn  # noqa: F401
from .celllist import NeighborInfo, knn_celllist  # noqa: F401
