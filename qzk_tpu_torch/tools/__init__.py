"""Command-line tools of the port that need no card."""
