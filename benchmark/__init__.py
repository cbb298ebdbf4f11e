"""The benchmark of ``ufvideo_tpu_torch``: ``benchmark/run.py`` runs one cell
(see ``README.md``)."""
