from .taxonomy import Taxonomy  # noqa: F401
