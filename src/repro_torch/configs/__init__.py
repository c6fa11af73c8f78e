from .registry import ARCH_IDS, get_config  # noqa: F401
