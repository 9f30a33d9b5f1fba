"""Segmentation metrics and the folder evaluator."""
