"""The port's walk-through of the reference's notebook (``tutorial``) and
its radio-stream case study (``case_study``), with the synthetic corpora
they run on (``synth``)."""
