"""Histogram-grown decision-tree weak learners (see trees.py)."""

from repro_torch.weak_tree.trees import TYPE_TREE, HistogramTrees

__all__ = ["HistogramTrees", "TYPE_TREE"]
