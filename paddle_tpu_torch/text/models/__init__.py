from .gpt import GPTConfig, GPTModel  # noqa: F401
