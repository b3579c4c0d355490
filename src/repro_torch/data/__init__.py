from .pipeline import (ByteCorpus, DataConfig, Prefetcher, SyntheticTokens,
                       make_pipeline)

__all__ = ["DataConfig", "SyntheticTokens", "ByteCorpus", "Prefetcher",
           "make_pipeline"]
