from . import equirect  # noqa: F401
