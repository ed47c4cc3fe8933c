from .attention import attention_bnsh, cached_attention  # noqa: F401
