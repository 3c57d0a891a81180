"""The parallel layer: device meshes and their collectives (``mesh.py``),
the gp-mesh graph build (``sharded_build.py``) and search
(``sharded_search.py``), and fine-tuning on one device or a (dp, tp) mesh
(``train.py``)."""
