from .config import Config, get_config, set_config  # noqa: F401
