from .facade import Simulator

__all__ = ["Simulator"]
