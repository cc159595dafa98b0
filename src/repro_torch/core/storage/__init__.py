"""Decoupled storage tiers (paper §3.3-§3.5): the block layout and its
accounting engine, the compressed vector store, the compressed index
store and the co-located baseline."""
