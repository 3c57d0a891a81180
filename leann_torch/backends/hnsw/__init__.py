from .backend import HnswBackendFactory, HnswBuilder, HnswSearcher  # noqa: F401
