from .vector_store import PendingSearch, SearchHit, VectorStore

__all__ = ["PendingSearch", "SearchHit", "VectorStore"]
