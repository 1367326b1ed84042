"""Hierarchical name -> value store whose values are torch tensors.

Counterpart of paddle_tpu/core/scope.py (reference: scope.h
Var/FindVar/NewScope).
"""


class Scope:
    def __init__(self, parent=None):
        self._vars = {}
        self._parent = parent
        self._kids = []

    def var(self, name):
        """Find or create."""
        if name not in self._vars:
            self._vars[name] = None
        return name

    def find_var(self, name):
        """The scope holding `name`, searching ancestors; None if
        absent."""
        s = self
        while s is not None:
            if name in s._vars:
                return s
            s = s._parent
        return None

    def has_var(self, name):
        return self.find_var(name) is not None

    def get(self, name, default=None):
        s = self.find_var(name)
        return s._vars[name] if s is not None else default

    def set(self, name, value):
        """Set in the nearest scope already holding `name`, else
        locally."""
        s = self.find_var(name)
        (s if s is not None else self)._vars[name] = value

    def set_local(self, name, value):
        """Set in this scope, whatever its ancestors hold."""
        self._vars[name] = value

    def new_scope(self):
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def __contains__(self, name):
        return self.has_var(name)


_global_scope = Scope()


def global_scope():
    return _global_scope
