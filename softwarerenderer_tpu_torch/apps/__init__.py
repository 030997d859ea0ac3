"""The applications that run on the port: the Dust2 game (``dust2``)."""
