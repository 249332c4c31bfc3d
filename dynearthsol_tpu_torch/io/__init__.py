from .tagged import TaggedReader, TaggedWriter
from .output import Output
from .restart import restart

__all__ = ["TaggedReader", "TaggedWriter", "Output", "restart"]
