"""Featurization: text vectorizers (TF-IDF ensembles) and preprocessing."""
