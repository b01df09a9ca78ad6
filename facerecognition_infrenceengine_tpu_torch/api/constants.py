"""Shared API constants.

The reference imports a top-level ``constants`` module that is missing from
the snapshot (reference app/api/employee.py:10); its only used symbol is
``POSES``.  Evidence pins the value: the enrollment worker iterates
``['center', 'left', 'right']`` (reference trainingServer.py:305) and the
visitor API stores exactly those three pose images (reference
app/api/visitor.py:78).

The port's copy of ``facerecognition_infrenceengine_tpu/api/constants.py``.
"""

POSES = ["center", "left", "right"]

ALLOWED_EXTENSIONS = {"png", "jpg", "jpeg"}
