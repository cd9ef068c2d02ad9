"""The survey's scripts on the port: counterparts of the JAX package's
``scripts/run_survey_demo.py``, ``scripts/run_timing_mode.py``,
``scripts/hd200_family_report.py`` and the three ``scripts/main_*.sh``
protocols. Each runs on the card unless asked for the CPU, and writes
under ``$CLSURVEY_ROOT`` unless given another path, never under
``docs/``."""
