from .api import Model, get_model  # noqa: F401
