"""Neurosymbolic ML layer of the PyTorch port: MLP neural predicates
(``torch.nn`` with autograd) trained end-to-end through differentiable
weighted model counting, the MODEL / NEURAL RELATION / TRAIN / ML.PREDICT
runtimes, and the external-model handler with MLSchema metadata.

Port of ``kolibrie_tpu/ml/``: the MLP's forward and VJP run as PyTorch ops
on the model's device (the CUDA card unless the caller passes another),
where the JAX package jit-compiles them with XLA.
"""
