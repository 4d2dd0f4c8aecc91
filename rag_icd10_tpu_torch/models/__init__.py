from .tokenizer import WordPieceTokenizer
from .encoder import TextEncoder

__all__ = ["WordPieceTokenizer", "TextEncoder"]
