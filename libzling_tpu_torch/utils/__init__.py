"""Host-side utilities; module names mirror ``libzling_tpu/utils``."""
