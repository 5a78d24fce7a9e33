"""Data layer: graph containers, static-shape batching, datasets."""
