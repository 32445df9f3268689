"""The benchmark's plain reference: the exact frontend (numpy), the
streaming detector (sequential Python), the EfficientNetB0 models (plain
PyTorch, gradients by autograd) and the training step's arithmetic.

Nothing here imports the program (``multilingual_kws_tpu_torch``), JAX or
the JAX package: ``kwsbench/tests/test_kwsbench_reference.py`` checks it.
"""
