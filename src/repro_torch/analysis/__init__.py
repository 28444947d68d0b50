"""Analyses over the dry-run tier's artifacts (``roofline``)."""
