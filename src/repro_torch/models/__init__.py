"""The port's model zoo: the dense decoder of the paged serving plane."""
from .transformer import DecoderLM  # noqa: F401
from .zoo import build_model  # noqa: F401
