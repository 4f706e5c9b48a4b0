"""Graph construction: top merge, selection, merge and sym passes."""
