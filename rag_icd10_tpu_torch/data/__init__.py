from .corpus import ICDCorpus, ICDRecord, parse_hierarchy, build_semantic_text

__all__ = ["ICDCorpus", "ICDRecord", "parse_hierarchy", "build_semantic_text"]
