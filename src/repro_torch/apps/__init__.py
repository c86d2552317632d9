from . import knots

__all__ = ["knots"]
