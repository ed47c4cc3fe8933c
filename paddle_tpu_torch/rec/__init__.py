"""Recommendation models (BASELINE workload 5: Wide&Deep CTR).

Counterpart of ``paddle_tpu/rec``, kept to ``wide_deep``.  Not ported:
``hogwild`` (HogwildTrainer, PSGPUTrainer), ``heter`` (HeterTrainer) and
``sharded_embedding`` (ROADMAP A11, A12).
"""
from .wide_deep import WideDeep, WideDeepTrainer, synthetic_ctr_batch  # noqa: F401

__all__ = ["WideDeep", "WideDeepTrainer", "synthetic_ctr_batch"]
