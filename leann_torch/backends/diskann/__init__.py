from .backend import DiskannBackendFactory, DiskannBuilder, DiskannSearcher  # noqa: F401
