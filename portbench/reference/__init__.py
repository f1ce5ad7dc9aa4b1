"""The plain references, one a model family, named by a configuration's
``reference``."""
