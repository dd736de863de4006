"""PyTorch/CUDA port of ``semseg_tpu`` (PSPNet and PSANet sliding-window serving).

Module paths and public names follow the JAX package (``ops/resize.py``,
``models/pspnet.py``, ``engine/evaluator.py``, ...). The package imports
``torch`` and never ``jax``/``flax``; ``cv2``, ``yaml`` and ``PIL`` are
imported only inside the functions that need them. Importing the package
imports nothing else.
"""
