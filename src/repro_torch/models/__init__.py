"""The port's model zoo: the decoder families and the encoder-decoder."""
from .encdec import EncDecLM  # noqa: F401
from .transformer import DecoderLM  # noqa: F401
from .zoo import build_model  # noqa: F401
