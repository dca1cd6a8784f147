"""Online serving for the port: the micro-batching ``ScorerServer``
(server.py) and its HTTP front end (frontend.py)."""
