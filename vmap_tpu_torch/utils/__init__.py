"""Utilities: the HTML scene viewer snapshot."""
