from .penl import save, load, SaveOptions, LoadOptions, compute_stable_ids

__all__ = ["save", "load", "SaveOptions", "LoadOptions",
           "compute_stable_ids"]
