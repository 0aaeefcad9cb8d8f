"""Architecture configs: copies of the reference's dataclasses and
registry (``get_config("<arch-id>")`` for ``--arch``)."""
