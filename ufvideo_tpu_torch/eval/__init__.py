"""The eval harness: the eight-benchmark runner (``run.py``), the benchmark
datasets, the J&F / tIoU / MCQA scorers and the description judge, a copy of
``ufvideo_tpu/eval`` on the port's ``mm_infer`` / ``mm_infer_batch``. Imports
numpy and torch only; PNG files go through ``png.py``."""
