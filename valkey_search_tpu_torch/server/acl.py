"""ACL: per-user key-prefix enforcement on FT.* commands.

Reference: src/acl.{h,cc} — AclPrefixCheck (acl.h:36-43) requires the
calling user's key ACL patterns to cover EVERY prefix of the index being
queried/created (stricter than Redisearch, COMPATIBILITY.md): a query
may only run if the user could read every key the index can possibly
contain. A glob pattern covers an index prefix iff it is `head*` with
the index prefix extending `head` (so all keys under the prefix match).

The port's own copy of valkey_search_tpu/server/acl.py, with its imports
pointing into valkey_search_tpu_torch.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Sequence, Tuple


class AclError(PermissionError):
    pass


@dataclasses.dataclass
class AclUser:
    name: str
    # fail closed (valkey ACL: a new user is off with -@all): commands and
    # AUTH are refused until the operator grants rules explicitly; only the
    # builtin default user is constructed enabled with categories
    enabled: bool = False
    key_patterns: Tuple[str, ...] = ()
    # command categories (+@read / -@all rules); "all" grants everything.
    # FT._DEBUG additionally requires "admin" (reference registers it with
    # admin flags — integration/test_debug.py
    # test_ft_debug_denied_without_admin_permissions)
    allowed_categories: Tuple[str, ...] = ()
    # explicit -@cat denials; a deny after +@all revokes that category
    # (redis ACL: later rules win, so `+@all -@admin` must not grant admin)
    denied_categories: Tuple[str, ...] = ()
    # sha-less plain passwords (redis ACL `>pw` rule); empty + nopass=False
    # means the user cannot be AUTH'd into at all
    passwords: Tuple[str, ...] = ()
    nopass: bool = False

    def check_password(self, password: str) -> bool:
        if not self.enabled:
            return False
        if self.nopass:
            return True
        return password in self.passwords

    def covers_prefix(self, prefix: str) -> bool:
        for pat in self.key_patterns:
            if pat == "*":
                return True
            if pat.endswith("*") and "*" not in pat[:-1]:
                head = pat[:-1]
                if prefix.startswith(head):
                    return True
        return False

    def may_touch_key(self, key: str) -> bool:
        import fnmatch

        return any(fnmatch.fnmatchcase(key, p) for p in self.key_patterns)

    def has_category(self, cat: str) -> bool:
        if cat in self.denied_categories:
            return False
        return "all" in self.allowed_categories \
            or cat in self.allowed_categories


# per-command ACL category sets (reference src/commands/commands.h:46-59):
# a user may run a command when granted ANY of its categories
COMMAND_CATEGORIES = {
    "FT.CREATE": ("search", "write", "fast"),
    "FT.DROPINDEX": ("search", "write", "fast"),
    "FT.INTERNAL_UPDATE": ("admin", "search", "write", "fast"),
    "FT.SEARCH": ("search", "read", "slow"),
    "FT.AGGREGATE": ("search", "read", "slow"),
    "FT.INFO": ("search", "read", "fast"),
    "FT._LIST": ("search", "read", "slow", "admin"),
    "FT._DEBUG": ("search", "slow", "dangerous", "admin"),
}


class AclManager:
    """User registry + the prefix check commands call."""

    def __init__(self):
        self._lock = threading.Lock()
        self._users: Dict[str, AclUser] = {
            "default": AclUser("default", enabled=True,
                               key_patterns=("*",),
                               allowed_categories=("all",))
        }

    def setuser(self, name: str, *rules: str) -> AclUser:
        with self._lock:
            user = self._users.get(name) or AclUser(name, key_patterns=())
            patterns = list(user.key_patterns)
            for rule in rules:
                if rule == "on":
                    user.enabled = True
                elif rule == "off":
                    user.enabled = False
                elif rule == "allkeys":
                    patterns = ["*"]
                elif rule == "resetkeys":
                    patterns = []
                elif rule.startswith("~"):
                    patterns.append(rule[1:])
                elif rule.startswith("%RW~") or rule.startswith("%R~"):
                    patterns.append(rule.split("~", 1)[1])
                elif rule.startswith(">"):
                    user.passwords = user.passwords + (rule[1:],)
                    user.nopass = False
                elif rule == "nopass":
                    user.nopass = True
                    user.passwords = ()
                elif rule == "resetpass":
                    user.nopass = False
                    user.passwords = ()
                elif rule.startswith("+@"):
                    cat = rule[2:].lower()
                    cats = set(user.allowed_categories)
                    cats.add("all" if cat == "all" else cat)
                    user.allowed_categories = tuple(sorted(cats))
                    user.denied_categories = tuple(
                        c for c in user.denied_categories if c != cat
                    )
                elif rule.startswith("-@"):
                    cat = rule[2:].lower()
                    if cat == "all":
                        user.allowed_categories = ()
                        user.denied_categories = ()
                    else:
                        user.allowed_categories = tuple(
                            c for c in user.allowed_categories if c != cat
                        )
                        user.denied_categories = tuple(sorted(
                            set(user.denied_categories) | {cat}
                        ))
                elif rule.startswith("&") or rule in ("allchannels",
                                                      "resetchannels"):
                    pass  # pub/sub channel rules: no pub/sub in this stack
                elif rule.startswith("+"):
                    pass  # per-command grants: categories are the unit here
                elif rule.startswith("-"):
                    # fail closed: a per-command DENY we cannot enforce must
                    # not be silently accepted (the operator would believe a
                    # restriction exists that does not)
                    raise AclError(
                        f"unsupported ACL rule {rule!r}: per-command deny "
                        "rules are not enforced by this engine"
                    )
                else:
                    raise AclError(f"unsupported ACL rule {rule!r}")
            user.key_patterns = tuple(patterns)
            self._users[name] = user
            return user

    def getuser(self, name: str) -> AclUser:
        with self._lock:
            u = self._users.get(name)
            if u is None:
                raise AclError(f"unknown user {name!r}")
            return u

    def deluser(self, name: str) -> None:
        if name == "default":
            raise AclError("cannot delete the default user")
        with self._lock:
            self._users.pop(name, None)

    def check_command(self, username: str, cmd: str) -> None:
        """Category gate: the user must hold ANY of the command's ACL
        categories (reference module_loader.cc command registration with
        kSearchCmdPermissions etc., drilled by integration/
        test_valkey_search_acl.py test_acl_category_permissions)."""
        cats = COMMAND_CATEGORIES.get(cmd.upper())
        if cats is None:
            return
        user = self.getuser(username)
        if not user.enabled or not any(user.has_category(c) for c in cats):
            raise AclError(
                f"User {username} has no permissions to run "
                f"the '{cmd}' command"
            )

    def check_index_access(self, username: str, prefixes: Sequence[str]) -> None:
        """Raises unless the user's key patterns cover every index prefix
        (reference AclPrefixCheck: called from all FT.* commands,
        commands.cc:166)."""
        user = self.getuser(username)
        if not user.enabled:
            raise AclError(f"user {username!r} is disabled")
        missing: List[str] = [
            p for p in prefixes if not user.covers_prefix(p)
        ]
        if missing:
            raise AclError(
                f"user {username!r} lacks key ACL coverage for index "
                f"prefixes {missing!r}"
            )
