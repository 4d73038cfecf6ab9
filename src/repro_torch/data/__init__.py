"""The synthetic token pipeline of the port (``data.tokens``)."""
