"""File formats and persistence (stage-file checkpoint contract): the
port's copies of panovlm_tpu/io, plus the PNG reader of io/images.py."""
