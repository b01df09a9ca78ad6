"""Domain runtimes over the engine: the live cameras (``cameras``), the
enrollment worker (``enrollment``), campus entry/exit counting (``campus``,
``counting``) and visitor passes with their QR codec (``passes``, ``qr``).
Importing it needs no Pillow: ``passes`` imports Pillow where it draws."""

from .passes import generate_visitor_pass, qr_decode, qr_encode  # noqa: F401
