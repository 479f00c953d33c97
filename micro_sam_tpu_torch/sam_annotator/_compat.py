"""Qt compatibility layer of the annotator widgets (the port's copy of
``micro_sam_tpu/sam_annotator/_compat.py``).

The widget classes in ``_widgets.py`` / ``training_ui.py`` are written against
a small form API (``FormWidget``) instead of raw QtWidgets. When qtpy is
installed the forms render to real Qt widgets; headless (in CI, or on a GPU
host without a display stack) the same classes construct with pure-Python
stand-ins, so every callback path runs without napari, as micro-sam's
``_WidgetBase`` cannot.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

try:  # real Qt when available
    from qtpy import QtWidgets as _QtW

    HAVE_QT = True
    QWidgetBase = _QtW.QWidget
    QScrollAreaBase = _QtW.QScrollArea
except Exception:  # headless: minimal stand-ins
    _QtW = None
    HAVE_QT = False

    class QWidgetBase:  # noqa: D401 - simple stand-in
        """Headless QWidget stand-in (layout + tooltip only)."""

        def __init__(self, parent=None):
            self._tooltip = None

        def setToolTip(self, tip):
            self._tooltip = tip

        def update(self):
            pass

    class QScrollAreaBase(QWidgetBase):
        def setWidget(self, w):
            self._widget = w

        def setWidgetResizable(self, flag):
            pass


class Signal:
    """Minimal signal: callback list with Qt-style connect/emit."""

    def __init__(self):
        self._slots: List[Callable] = []
        self._blocked = False

    def connect(self, fn: Callable) -> None:
        self._slots.append(fn)

    def disconnect(self, fn: Callable) -> None:
        self._slots.remove(fn)

    def emit(self, *args) -> None:
        if self._blocked:
            return
        for fn in list(self._slots):
            fn(*args)


class _Field:
    """One form field: owns the value on the owner widget, fires ``changed``
    on writes, and mirrors into a Qt editor when rendered."""

    def __init__(self, owner, name: str, value, kind: str, options=None,
                 min_val=None, max_val=None, step=None, title=None,
                 tooltip=None, placeholder=None, decimals=None):
        self.owner = owner
        self.name = name
        self.kind = kind
        self.options = list(options) if options is not None else None
        self.min_val, self.max_val, self.step = min_val, max_val, step
        self.title = title or name
        self.tooltip = tooltip
        self.placeholder = placeholder
        self.decimals = decimals
        self.changed = Signal()
        self._blocked = False
        setattr(owner, name, value)

    # -- value plumbing ----------------------------------------------------
    def get(self):
        return getattr(self.owner, self.name)

    def set(self, value, from_gui: bool = False):
        setattr(self.owner, self.name, value)
        if not self._blocked:
            self.changed.emit(value)

    def blockSignals(self, flag: bool) -> None:
        self._blocked = bool(flag)
        self.changed._blocked = bool(flag)

    # Qt-ish aliases used by choice fields
    def setCurrentText(self, text):
        self.set(text)

    def currentText(self):
        return self.get()

    def clear(self):
        self.options = []

    def addItems(self, items):
        self.options = (self.options or []) + list(items)

    def setChoices(self, options):
        self.options = list(options)

    def setText(self, text):
        self.set(text)

    def setValue(self, value):
        self.set(value)


class FormWidget(QWidgetBase):
    """Base widget: declarative params stored as attributes, change signals,
    optional Qt rendering. The ``_add_*`` helpers mirror micro-sam's
    _WidgetBase API shape so widget code reads the same."""

    def __init__(self, parent=None):
        super().__init__(parent) if HAVE_QT else super().__init__()
        self._fields: dict = {}
        self._buttons: dict = {}
        self._qt_rows: list = []  # deferred Qt row builders
        if HAVE_QT:
            self.setLayout(_QtW.QVBoxLayout())

    # -- field factories -----------------------------------------------------
    def _register(self, field: _Field) -> _Field:
        self._fields[field.name] = field
        if HAVE_QT:
            self._render_field(field)
        return field

    def _add_bool_param(self, name, value, title=None, tooltip=None) -> _Field:
        return self._register(_Field(self, name, value, "bool", title=title, tooltip=tooltip))

    def _add_string_param(self, name, value, title=None, placeholder=None, tooltip=None) -> _Field:
        return self._register(_Field(self, name, value, "str", title=title,
                                     placeholder=placeholder, tooltip=tooltip))

    def _add_path_param(self, name, value, select_type="file", title=None,
                        placeholder=None, tooltip=None) -> _Field:
        f = _Field(self, name, value, "path", title=title,
                   placeholder=placeholder, tooltip=tooltip)
        f.select_type = select_type
        return self._register(f)

    def _add_int_param(self, name, value, min_val=0, max_val=100, step=1,
                       title=None, tooltip=None) -> _Field:
        return self._register(_Field(self, name, value, "int", min_val=min_val,
                                     max_val=max_val, step=step, title=title, tooltip=tooltip))

    def _add_float_param(self, name, value, min_val=0.0, max_val=1.0, step=0.01,
                         decimals=2, title=None, tooltip=None) -> _Field:
        return self._register(_Field(self, name, value, "float", min_val=min_val,
                                     max_val=max_val, step=step, decimals=decimals,
                                     title=title, tooltip=tooltip))

    def _add_choice_param(self, name, value, options: Sequence[str], title=None,
                          tooltip=None, update: Optional[Callable] = None) -> _Field:
        f = self._register(_Field(self, name, value, "choice", options=options,
                                  title=title, tooltip=tooltip))
        if update is not None:
            f.changed.connect(lambda *_: update())
        return f

    def _add_shape_param(self, names, values, min_val, max_val, step=1,
                         title=None, tooltip=None):
        fx = self._add_int_param(names[0], values[0], min_val=min_val, max_val=max_val,
                                 step=step, title=(title[0] if title else names[0]),
                                 tooltip=tooltip)
        fy = self._add_int_param(names[1], values[1], min_val=min_val, max_val=max_val,
                                 step=step, title=(title[1] if title else names[1]),
                                 tooltip=tooltip)
        return fx, fy

    def _add_button(self, name, text, on_click: Callable, tooltip=None) -> "Button":
        button = Button(text, on_click, tooltip=tooltip)
        self._buttons[name] = button
        if HAVE_QT:
            qbtn = _QtW.QPushButton(text)
            qbtn.clicked.connect(lambda *_: button.click())
            if tooltip:
                qbtn.setToolTip(tooltip)
            self.layout().addWidget(qbtn)
            button._qt = qbtn
        return button

    def set_param(self, name: str, value) -> None:
        """Programmatic write that fires change callbacks (what the GUI edit
        would do) — the entry point tests use to drive callback wiring."""
        self._fields[name].set(value)

    # -- Qt rendering --------------------------------------------------------
    def _render_field(self, f: _Field) -> None:
        row = _QtW.QHBoxLayout()
        if f.kind == "bool":
            box = _QtW.QCheckBox(f.title)
            box.setChecked(bool(f.get()))
            box.stateChanged.connect(lambda v: f.set(bool(v)))
            row.addWidget(box)
        else:
            label = _QtW.QLabel(f.title)
            row.addWidget(label)
            if f.kind in ("str", "path"):
                edit = _QtW.QLineEdit()
                edit.setText("" if f.get() is None else str(f.get()))
                if f.placeholder:
                    edit.setPlaceholderText(f.placeholder)
                edit.textChanged.connect(lambda v: f.set(v))
                row.addWidget(edit)
            elif f.kind == "int":
                spin = _QtW.QSpinBox()
                spin.setRange(int(f.min_val), int(f.max_val))
                spin.setValue(int(f.get()))
                spin.setSingleStep(int(f.step or 1))
                spin.valueChanged.connect(lambda v: f.set(int(v)))
                row.addWidget(spin)
            elif f.kind == "float":
                spin = _QtW.QDoubleSpinBox()
                spin.setRange(float(f.min_val), float(f.max_val))
                spin.setDecimals(int(f.decimals or 2))
                spin.setValue(float(f.get()))
                spin.setSingleStep(float(f.step or 0.01))
                spin.valueChanged.connect(lambda v: f.set(float(v)))
                row.addWidget(spin)
            elif f.kind == "choice":
                combo = _QtW.QComboBox()
                combo.addItems([str(o) for o in (f.options or [])])
                if f.get() is not None:
                    idx = combo.findText(str(f.get()))
                    if idx >= 0:
                        combo.setCurrentIndex(idx)
                combo.currentTextChanged.connect(lambda v: f.set(v))
                row.addWidget(combo)
        if f.tooltip:
            for i in range(row.count()):
                w = row.itemAt(i).widget()
                if w is not None:
                    w.setToolTip(f.tooltip)
        self.layout().addLayout(row)


class Button:
    """Render-agnostic push button; ``click()`` drives the wiring headless."""

    def __init__(self, text: str, on_click: Optional[Callable] = None, tooltip=None):
        self.text = text
        self.tooltip = tooltip
        self.clicked = Signal()
        if on_click is not None:
            self.clicked.connect(lambda *_: on_click())
        self._qt = None

    def click(self):
        self.clicked.emit()

    def setToolTip(self, tip):
        self.tooltip = tip


# ---------------------------------------------------------------------------
# message / dialog handling
# ---------------------------------------------------------------------------

#: pluggable handler(message_type, message) -> bool (abort?). Tests override
#: this; the Qt path pops dialogs as micro-sam's _generate_message does.
_message_handler: Optional[Callable[[str, str], bool]] = None
_messages: List = []  # (type, message) log, inspectable by tests


def set_message_handler(handler: Optional[Callable[[str, str], bool]]) -> None:
    global _message_handler
    _message_handler = handler


def generate_message(message_type: str, message: str) -> bool:
    """Show an error (abort) or info (OK/Cancel) message. Returns True if the
    calling operation should abort (micro-sam's _generate_message)."""
    _messages.append((message_type, message))
    if _message_handler is not None:
        return bool(_message_handler(message_type, message))
    if HAVE_QT:
        if message_type == "error":
            _QtW.QMessageBox.critical(None, "Error", message, _QtW.QMessageBox.Ok)
            return True
        result = _QtW.QMessageBox.information(
            None, "Validation Message", message,
            _QtW.QMessageBox.Ok | _QtW.QMessageBox.Cancel,
        )
        return result == _QtW.QMessageBox.Cancel
    # headless default: errors abort loudly, infos proceed
    if message_type == "error":
        import warnings
        warnings.warn(f"annotator error: {message}")
        return True
    return False
