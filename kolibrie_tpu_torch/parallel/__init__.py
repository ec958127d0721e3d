"""Training and (later) multi-device paths of the PyTorch port.

``train_step`` holds the single-device half of
``kolibrie_tpu/parallel/train_step.py``; the mesh paths come with the
multi-device slice.
"""
