"""ES5-subset JavaScript engine for MapReduce user functions.

The reference executes MapReduce jobs as JavaScript on an embedded
SpiderMonkey (reference: mapreduce/runtime/javascript/
javascript_context.cc; JS_Init at db/database.cc:379-384). This
package is this engine's equivalent: a small, dependency-free
interpreter covering the language surface MapReduce jobs use —
functions/closures, objects/arrays, control flow, the standard
operator set, and the JSON/Math/String/Array/Object builtins.

Host-side integration (EVQL driver API, evql_* bindings) lives in
eventql_tpu.mapreduce.js_runtime.
"""

from eventql_tpu.mapreduce.js.interp import (  # noqa: F401
    UNDEFINED,
    Interpreter,
    JSArray,
    JSError,
    JSFunction,
    JSObject,
    js_repr,
    js_to_python,
    python_to_js,
)
