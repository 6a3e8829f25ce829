"""Host-side evaluation tools: the HTML log player."""
