"""The dry run's roofline and its report (``roofline``, ``report``)."""
