from .knn import knn  # noqa: F401
