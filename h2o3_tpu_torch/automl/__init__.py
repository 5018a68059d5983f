"""`h2o.automl` of the port — reference parity: `h2o-py/h2o/automl/` +
`h2o-automl/`."""

from .automl import EventLog, H2OAutoML, Leaderboard

__all__ = ["H2OAutoML", "Leaderboard", "EventLog"]
