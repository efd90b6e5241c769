"""Utilities: the HTML scene viewer snapshot, headless visualisation and
the PNG codec of the Replica layout."""
