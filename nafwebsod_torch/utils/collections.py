"""Attribute-style config mapping (copy of the JAX package's module).

Provides the capability the reference's config system relies on
(``detectron/utils/collections.py``: a dict whose keys read/write as
attributes, with a recursive freeze used by ``assert_and_infer_cfg``) —
re-designed here: the frozen flag lives as a private instance attribute set
through ``object.__setattr__``, and the freeze propagates with an explicit
worklist instead of recursion.
"""

_FROZEN_ATTR = "_attrdict_frozen"


class AttrDict(dict):
    """A ``dict`` whose string keys double as attributes.

    ``d.foo`` reads ``d['foo']``; ``d.foo = x`` writes ``d['foo'] = x``.
    ``immutable(True)`` freezes this node and every nested :class:`AttrDict`
    (reachable through values or instance attributes) against attribute
    assignment until ``immutable(False)``.
    """

    # Legacy name kept so callers poking at the flag keep working.
    IMMUTABLE = _FROZEN_ATTR

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        object.__setattr__(self, _FROZEN_ATTR, False)

    # -- attribute protocol -------------------------------------------------

    def __getattr__(self, name):
        # Reached only when normal attribute lookup fails: fall back to keys.
        if name in self:
            return dict.__getitem__(self, name)
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if getattr(self, _FROZEN_ATTR, False):
            msg = (f"AttrDict is frozen; rejected setting {name!r} = "
                   f"{value!r}. Call .immutable(False) first.")
            raise AttributeError(msg)
        # Real instance attributes (rare) stay attributes; everything else
        # becomes a mapping entry.
        if name in vars(self):
            object.__setattr__(self, name, value)
            return
        dict.__setitem__(self, name, value)

    # -- freeze protocol -----------------------------------------------------

    def immutable(self, is_immutable):
        """(Un)freeze this AttrDict and all nested AttrDicts."""
        flag = bool(is_immutable)
        pending = [self]
        while pending:
            node = pending.pop()
            object.__setattr__(node, _FROZEN_ATTR, flag)
            children = list(node.values()) + list(vars(node).values())
            pending.extend(c for c in children if isinstance(c, AttrDict))

    def is_immutable(self):
        return getattr(self, _FROZEN_ATTR, False)
