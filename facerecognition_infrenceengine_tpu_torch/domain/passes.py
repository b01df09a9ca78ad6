"""Visitor pass generation and QR encode/decode.

Capability parity with the reference's ``generate_visitor_pass`` (reference
app/api/visitor.py:191-592): a 1000x1400 PNG with a branded header, visitor/
host/visit-detail/access sections, a circular center face crop, a QR code
whose payload is the visit ``_id``, instruction bullets, an authorization
signature strip, and a footer.  Layout is re-designed, not traced; the
*content contract* (fields shown, QR payload, PNG format, dimensions) is
preserved.

QR: the reference encodes via the ``qrcode`` package and its verify endpoint
is broken by construction (it feeds PNG bytes to a QR *encoder* and reads a
nonexistent attribute, reference visitor.py:1040-1052).  Here BOTH
directions are the framework's own ISO 18004 implementation
(``domain/qr.py`` — byte mode, Reed-Solomon, mask selection, and a
clean-synthetic decoder) so verify actually decodes, with no cv2 anywhere
in the pass stack (tests cross-check the codec against OpenCV as an
optional oracle).

The port's copy of ``facerecognition_infrenceengine_tpu/domain/passes.py``.
Pillow is imported by the functions that draw or open images, not by the
module: ``domain`` (and with it ``domain.cameras``) imports where Pillow is
not installed, and there these functions raise an ``ImportError`` naming
Pillow.
"""

from __future__ import annotations

import io

import numpy as np

from . import qr as qrcodec


def _pil():
    """Pillow's ``Image``, ``ImageDraw`` and ``ImageFont`` modules."""
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:
        raise ImportError("visitor passes and QR images need Pillow (PIL), "
                          "which is not installed") from e
    return Image, ImageDraw, ImageFont


# ------------------------------------------------------------------- QR
def qr_encode(payload: str, module_px: int = 10, border_modules: int = 4) -> Image.Image:
    """Encode ``payload`` into a PIL image (black on white, quiet zone)."""
    Image, _, _ = _pil()
    matrix = qrcodec.encode(payload)
    img = qrcodec.render(matrix, module_px=module_px,
                         border_modules=border_modules)
    return Image.fromarray(img).convert("RGB")


def qr_decode(image_bytes: bytes) -> str | None:
    """Decode a QR payload from PNG/JPEG bytes; None when undecodable."""
    Image, _, _ = _pil()
    try:
        img = Image.open(io.BytesIO(image_bytes)).convert("L")
    except Exception:
        return None
    payload = qrcodec.decode_image(np.asarray(img))
    if payload is None:
        return None
    try:
        return payload.decode("utf-8")
    except UnicodeDecodeError:
        return None


# ----------------------------------------------------------------- fonts
def _font(size: int, bold: bool = False):
    _, _, ImageFont = _pil()
    names = (["DejaVuSans-Bold.ttf", "Arial-Bold.ttf"] if bold
             else ["DejaVuSans.ttf", "Arial.ttf"])
    for name in names:
        try:
            return ImageFont.truetype(name, size)
        except OSError:
            continue
    return ImageFont.load_default()


COLORS = {
    "primary": (0, 51, 102),
    "secondary": (240, 240, 240),
    "accent": (0, 102, 204),
    "text": (33, 33, 33),
    "subtext": (100, 100, 100),
    "white": (255, 255, 255),
    "border": (220, 220, 220),
    "section_bg": (248, 250, 255),
}

WIDTH, HEIGHT = 1000, 1400
MARGIN = 50
QR_SIZE = 300
IMG_SIZE = 300


def _fmt_dt(dt) -> str:
    if dt is None:
        return ""
    if isinstance(dt, str):
        return dt
    try:
        return dt.strftime("%d %b %Y, %H:%M")
    except Exception:
        return str(dt)


def generate_visitor_pass(visitor: dict, host: dict, data: dict, visit_id,
                          arrival, departure,
                          face_image_bytes: bytes | None = None) -> bytes:
    """Compose the visitor pass PNG; returns PNG bytes.

    ``face_image_bytes``: the center pose image (callers resolve it from
    GridFS; keeping IO out of here makes the composer pure).
    """
    Image, ImageDraw, _ = _pil()
    img = Image.new("RGB", (WIDTH, HEIGHT), COLORS["white"])
    draw = ImageDraw.Draw(img)
    title_f = _font(42, bold=True)
    header_f = _font(28, bold=True)
    label_f = _font(20, bold=True)
    text_f = _font(20)
    small_f = _font(18)

    # header band
    header_h = 110
    draw.rectangle([(0, 0), (WIDTH, header_h)], fill=COLORS["primary"])
    draw.rectangle([(0, header_h - 3), (WIDTH, header_h)], fill=COLORS["accent"])
    draw.text((MARGIN, (header_h - 42) // 2), "VISITOR PASS",
              fill=COLORS["white"], font=title_f)
    id_text = f"ID: {visit_id}"
    w = draw.textlength(id_text, font=small_f)
    draw.text((WIDTH - MARGIN - w, (header_h - 18) // 2), id_text,
              fill=COLORS["white"], font=small_f)

    col_gap = 40
    col_w = (WIDTH - 2 * MARGIN - col_gap) // 2
    top_y = header_h + MARGIN

    def section(x, y, title, rows):
        rows = [(label, "" if value is None else str(value)) for label, value in rows]
        height = 28 + 20 + sum(max(1, r[1].count("\n") + 1) * 30 for r in rows) + 20
        draw.rectangle([(x - 10, y - 10), (x + col_w + 10, y + height)],
                       fill=COLORS["section_bg"], outline=COLORS["border"])
        draw.text((x, y), title, fill=COLORS["primary"], font=header_f)
        yy = y + 28 + 14
        draw.line([(x, yy - 6), (x + col_w, yy - 6)], fill=COLORS["border"])
        for label, value in rows:
            draw.text((x, yy), label, fill=COLORS["primary"], font=label_f)
            for i, line in enumerate(value.split("\n")):
                draw.text((x + 150, yy + i * 30), line, fill=COLORS["text"], font=text_f)
            yy += max(1, value.count("\n") + 1) * 30
        return y + height + 25

    left_y = section(MARGIN, top_y, "Visitor Information", [
        ("Name:", visitor.get("visitorName", "")),
        ("Company:", visitor.get("organization", "")),
        ("Email:", visitor.get("email", "")),
        ("Phone:", visitor.get("phone", "")),
        ("ID Type:", visitor.get("idType", "")),
        ("ID Number:", visitor.get("idNumber", "")),
    ])
    left_y = section(MARGIN, left_y, "Host Information", [
        ("Name:", (host or {}).get("employeeName", "")),
        ("Designation:", (host or {}).get("employeeDesignation", "")),
        ("Email:", (host or {}).get("employeeEmail", "")),
        ("Phone:", (host or {}).get("employeeMobile", "")),
    ])
    left_y = section(MARGIN, left_y, "Visit Details", [
        ("Purpose:", data.get("purpose", "")),
        ("Arrival:", _fmt_dt(arrival)),
        ("Departure:", _fmt_dt(departure)),
        ("Location:", data.get("location", "")),
    ])
    zones = data.get("accessAreas") or data.get("accessZones") or []
    if zones:
        left_y = section(MARGIN, left_y, "Access Information", [
            ("Access Zones:", "\n".join(f"* {z}" for z in zones)),
        ])

    # right column: circular face crop + QR
    right_x = MARGIN + col_w + col_gap
    face_box_x = right_x + (col_w - IMG_SIZE) // 2
    face_y = top_y
    if face_image_bytes:
        try:
            face = Image.open(io.BytesIO(face_image_bytes)).convert("RGB")
            face = face.resize((IMG_SIZE, IMG_SIZE))
            mask = Image.new("L", (IMG_SIZE, IMG_SIZE), 0)
            ImageDraw.Draw(mask).ellipse((0, 0, IMG_SIZE, IMG_SIZE), fill=255)
            draw.ellipse((face_box_x - 4, face_y - 4,
                          face_box_x + IMG_SIZE + 4, face_y + IMG_SIZE + 4),
                         fill=COLORS["primary"])
            img.paste(face, (face_box_x, face_y), mask)
        except Exception:
            face_image_bytes = None
    if not face_image_bytes:
        draw.ellipse((face_box_x, face_y, face_box_x + IMG_SIZE, face_y + IMG_SIZE),
                     fill=COLORS["secondary"], outline=COLORS["primary"], width=2)
        w = draw.textlength("No Image", font=text_f)
        draw.text((face_box_x + (IMG_SIZE - w) // 2, face_y + IMG_SIZE // 2 - 10),
                  "No Image", fill=COLORS["subtext"], font=text_f)

    qr_img = qr_encode(str(visit_id)).resize((QR_SIZE, QR_SIZE), Image.NEAREST)
    qr_x = right_x + (col_w - QR_SIZE) // 2
    qr_y = face_y + IMG_SIZE + 40
    draw.rectangle([(qr_x - 16, qr_y - 16), (qr_x + QR_SIZE + 16, qr_y + QR_SIZE + 16)],
                   fill=COLORS["white"], outline=COLORS["border"], width=2)
    img.paste(qr_img, (qr_x, qr_y))

    # instructions
    instr_y = max(left_y, qr_y + QR_SIZE + 40) + 20
    draw.rectangle([(MARGIN - 10, instr_y - 10),
                    (WIDTH - MARGIN + 10, instr_y + 150)],
                   fill=COLORS["section_bg"], outline=COLORS["border"], width=2)
    draw.text((MARGIN + 20, instr_y + 10), "Instructions:",
              fill=COLORS["primary"], font=header_f)
    yy = instr_y + 50
    for line in ("* Present this QR code at reception",
                 "* Keep this pass visible at all times",
                 "* Valid only during specified time period",
                 "* Return to reception upon departure"):
        draw.text((MARGIN + 30, yy), line, fill=COLORS["text"], font=text_f)
        yy += 25

    # authorization strip
    auth_y = instr_y + 170
    draw.rectangle([(MARGIN - 10, auth_y - 10),
                    (WIDTH - MARGIN + 10, auth_y + 150)],
                   fill=COLORS["white"], outline=COLORS["border"], width=2)
    draw.text((MARGIN + 20, auth_y + 10), "Authorization",
              fill=COLORS["primary"], font=header_f)
    sig_w = (WIDTH - 2 * MARGIN - 40) // 3
    for i, (title, sub) in enumerate((("Security (Entry)", "Name & Timestamp"),
                                      ("Host Approval", "Signature & Date"),
                                      ("Security (Exit)", "Name & Timestamp"))):
        x = MARGIN + 20 + i * sig_w
        draw.text((x, auth_y + 70), title, fill=COLORS["primary"], font=label_f)
        draw.line([(x, auth_y + 110), (x + sig_w - 20, auth_y + 110)],
                  fill=COLORS["text"])
        draw.text((x, auth_y + 120), sub, fill=COLORS["subtext"], font=small_f)

    # footer
    footer_y = HEIGHT - 70
    draw.rectangle([(0, footer_y), (WIDTH, HEIGHT)], fill=COLORS["secondary"])
    draw.rectangle([(0, footer_y), (WIDTH, footer_y + 2)], fill=COLORS["accent"])
    footer = "This pass must be worn visibly at all times while on the premises."
    w = draw.textlength(footer, font=text_f)
    draw.text(((WIDTH - w) // 2, footer_y + 25), footer,
              fill=COLORS["primary"], font=text_f)

    out = io.BytesIO()
    img.save(out, format="PNG")
    return out.getvalue()
