"""Audio I/O, corpora, on-the-fly mixture synthesis and prefetching."""
