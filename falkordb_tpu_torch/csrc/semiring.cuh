// The semiring library's device vocabulary (kernels K19-K21): dtype codes,
// typed loads, the multiply binops, the add monoids with their identities,
// masks, and the order-preserving int images that let integer atomics act
// as float32 / float64 min and max.
//
// One semiring application is described by a 64-bit code that the Python
// wrappers pack (falkordb_tpu_torch/sparse/ops.py `_sem_code`), so an entry
// point takes any registered semiring without a template for each:
//   bits  0-3  mul    bits 16-19 xcode (x or B)   bits 32-35 ecode (edge mask)
//   bits  4-7  add    bits 20-23 scode (semiring) bit  36    complement
//   bits  8-11 pcode  bits 24-27 ocode (output)
//   bits 12-15 vcode  bits 28-31 mcode (output mask)
// pcode is the type the JAX package's promotion gives the multiply
// (int32 * float32 -> float32, float32 * float64 -> float64; `first` and
// `second` take x's type, `and` and `pair` bool, `value` the edge's).  A
// contribution is computed in that type, cast to the semiring's dtype
// (scode, as `_neutralize` does) and then to the accumulator (ocode: the
// semiring's dtype, or int64 where the reference's jnp.sum promotes an
// integer sum).  float32 arithmetic is done in double and rounded once to
// float32, which gives the float32 result bit for bit (53 >= 2 * 24 + 2).
// min and max propagate NaN, as jnp.minimum / jnp.maximum and XLA's segment
// reduces do (CUDA's fminf / fmaxf do not).
//
// The per-entry helpers (multiply, contrib, edge_on, keep_out) take the
// application as a spec: `Sem` reads every code at run time (the dynamic
// spec); `Fixed<...>` names the codes of one semiring application as
// compile-time constants, so the same helper bodies fold their type
// switches away and a kernel instantiated with it keeps several gathers in
// flight.  The rules (identity, NaN, masks, casts) are written once, here.
#pragma once

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace fk {

enum : int { T_NONE = 0, T_BOOL = 1, T_I32 = 2, T_I64 = 3, T_F32 = 4, T_F64 = 5 };
enum : int {
  M_TIMES = 0, M_PLUS = 1, M_MIN = 2, M_MAX = 3, M_AND = 4, M_PAIR = 5,
  M_FIRST = 6, M_SECOND = 7, M_VALUE = 8  // VALUE: the edge value alone
};
enum : int { A_PLUS = 0, A_MIN = 1, A_MAX = 2, A_OR = 3, A_ANY = 4 };

struct Sem {
  static constexpr bool fixed = false;
  int mul, add, pcode, vcode, xcode, scode, ocode, mcode, ecode, complement;
  const void* vals;   // edge values (vcode; T_NONE: every value is 1)
  const void* x;      // the gathered operand (xcode)
  const void* omask;  // output mask over rows / columns, or null
  const void* emask;  // edge mask over the matrix's entries, or null
};

inline Sem make_sem(int64_t code, const void* vals, const void* x,
                    const void* omask, const void* emask) {
  Sem s;
  s.mul = (int)(code & 15);
  s.add = (int)((code >> 4) & 15);
  s.pcode = (int)((code >> 8) & 15);
  s.vcode = (int)((code >> 12) & 15);
  s.xcode = (int)((code >> 16) & 15);
  s.scode = (int)((code >> 20) & 15);
  s.ocode = (int)((code >> 24) & 15);
  s.mcode = (int)((code >> 28) & 15);
  s.ecode = (int)((code >> 32) & 15);
  s.complement = (int)((code >> 36) & 1);
  s.vals = vals;
  s.x = x;
  s.omask = omask;
  s.emask = emask;
  return s;
}

// A compile-time spec: the codes of one application (bits 0-35 of the
// 64-bit code but the output mask's type), with the operands and the
// output mask's type and complement read from a Sem at run time.
// `ignore` marks code bits the application never reads (a pair multiply
// reads no value), which a code need not match.
template <int MUL, int ADD, int PCODE, int VCODE, int XCODE, int SCODE, int OCODE,
          int ECODE>
struct Fixed {
  static constexpr bool fixed = true;
  static constexpr int mul = MUL, add = ADD, pcode = PCODE, vcode = VCODE,
                       xcode = XCODE, scode = SCODE, ocode = OCODE, ecode = ECODE;
  static constexpr int64_t code =
      (int64_t)MUL | ((int64_t)ADD << 4) | ((int64_t)PCODE << 8) |
      ((int64_t)VCODE << 12) | ((int64_t)XCODE << 16) | ((int64_t)SCODE << 20) |
      ((int64_t)OCODE << 24) | ((int64_t)ECODE << 32);
  static constexpr int64_t ignore = MUL == M_PAIR ? (int64_t)15 << 12 : 0;
  int mcode, complement;
  const void* vals;
  const void* x;
  const void* omask;
  const void* emask;
  // Does a packed code describe this application?  The output mask's type
  // (bits 28-31) and the complement (bit 36) stay run-time fields.
  static bool matches(int64_t c) {
    const int64_t fields = ((int64_t)1 << 36) - 1 - ((int64_t)15 << 28) - ignore;
    return (c & fields) == code;
  }
  explicit Fixed(const Sem& s)
      : mcode(s.mcode), complement(s.complement), vals(s.vals), x(s.x),
        omask(s.omask), emask(s.emask) {}
};

// -- loads ------------------------------------------------------------------

__device__ __forceinline__ double ld_f(const void* p, int code, int64_t i) {
  switch (code) {
    case T_BOOL: return ((const uint8_t*)p)[i] ? 1.0 : 0.0;
    case T_I32: return (double)((const int32_t*)p)[i];
    case T_I64: return (double)((const long long*)p)[i];
    case T_F32: return (double)((const float*)p)[i];
    case T_F64: return ((const double*)p)[i];
    default: return 1.0;
  }
}

// Integer loads truncate floats toward zero, as astype does.
__device__ __forceinline__ long long ld_i(const void* p, int code, int64_t i) {
  switch (code) {
    case T_BOOL: return ((const uint8_t*)p)[i] ? 1 : 0;
    case T_I32: return (long long)((const int32_t*)p)[i];
    case T_I64: return ((const long long*)p)[i];
    case T_F32: return (long long)((const float*)p)[i];
    case T_F64: return (long long)((const double*)p)[i];
    default: return 1;
  }
}

__device__ __forceinline__ bool ld_nz(const void* p, int code, int64_t i) {
  switch (code) {
    case T_BOOL: return ((const uint8_t*)p)[i] != 0;
    case T_I32: return ((const int32_t*)p)[i] != 0;
    case T_I64: return ((const long long*)p)[i] != 0;
    case T_F32: return ((const float*)p)[i] != 0.0f;  // NaN counts as set
    case T_F64: return ((const double*)p)[i] != 0.0;
    default: return true;
  }
}

// A stored value converted to the float type `pcode` (one rounding).
__device__ __forceinline__ double ld_as_float(const void* p, int code, int64_t i,
                                              int pcode) {
  if (pcode == T_F32) {
    switch (code) {
      case T_I32: return (double)(float)((const int32_t*)p)[i];
      case T_I64: return (double)(float)((const long long*)p)[i];
      case T_F64: return (double)(float)((const double*)p)[i];
      default: return ld_f(p, code, i);
    }
  }
  return ld_f(p, code, i);
}

__device__ __forceinline__ long long wrap_i32(long long v) {
  return (long long)(int32_t)(uint32_t)(unsigned long long)v;
}

// -- a value on its way from the multiply to the accumulator -----------------

struct Num {
  double f;
  long long i;
  bool is_f;
};

__device__ __forceinline__ Num num_f(double f) { return Num{f, 0, true}; }
__device__ __forceinline__ Num num_i(long long i) { return Num{0.0, i, false}; }

// Cast to `code` (astype): float32 rounds, int32 wraps, bool tests != 0.
__device__ __forceinline__ Num cast_to(Num v, int code) {
  switch (code) {
    case T_F32: return num_f(v.is_f ? (double)(float)v.f : (double)(float)v.i);
    case T_F64: return num_f(v.is_f ? v.f : (double)v.i);
    case T_I32: return num_i(v.is_f ? (long long)(int32_t)v.f : wrap_i32(v.i));
    case T_I64: return num_i(v.is_f ? (long long)v.f : v.i);
    default: return num_i(v.is_f ? (v.f != 0.0) : (v.i != 0));  // T_BOOL
  }
}

template <class OT>
__device__ __forceinline__ OT out_of(Num v) {
  return v.is_f ? (OT)v.f : (OT)v.i;
}

__device__ __forceinline__ double fmin_nan(double a, double b) {
  return (isnan(a) || isnan(b)) ? (a + b) : (a < b ? a : b);
}
__device__ __forceinline__ double fmax_nan(double a, double b) {
  return (isnan(a) || isnan(b)) ? (a + b) : (a > b ? a : b);
}

// The multiply of edge `ve` with x[xi], in the promoted type.
template <class S>
__device__ __forceinline__ Num multiply(const S& s, int64_t ve, int64_t xi) {
  if (s.mul == M_PAIR) return num_i(ld_nz(s.x, s.xcode, xi) ? 1 : 0);
  if (s.mul == M_AND) {
    return num_i((ld_nz(s.vals, s.vcode, ve) && ld_nz(s.x, s.xcode, xi)) ? 1 : 0);
  }
  const bool use_a = s.mul != M_SECOND;
  const bool use_b = s.mul != M_FIRST && s.mul != M_VALUE;
  if (s.pcode == T_F32 || s.pcode == T_F64) {
    const double a = use_a ? ld_as_float(s.vals, s.vcode, ve, s.pcode) : 0.0;
    const double b = use_b ? ld_as_float(s.x, s.xcode, xi, s.pcode) : 0.0;
    double r;
    switch (s.mul) {
      case M_TIMES: r = a * b; break;
      case M_PLUS: r = a + b; break;
      case M_MIN: r = fmin_nan(a, b); break;
      case M_MAX: r = fmax_nan(a, b); break;
      case M_SECOND: r = b; break;
      default: r = a;  // M_FIRST, M_VALUE
    }
    return cast_to(num_f(r), s.pcode);
  }
  long long a = 0, b = 0;
  if (use_a) a = cast_to(num_i(ld_i(s.vals, s.vcode, ve)), s.pcode).i;
  if (use_b) b = cast_to(num_i(ld_i(s.x, s.xcode, xi)), s.pcode).i;
  long long r;
  switch (s.mul) {
    case M_TIMES:
      r = (long long)((unsigned long long)a * (unsigned long long)b);
      break;
    case M_PLUS:
      r = (long long)((unsigned long long)a + (unsigned long long)b);
      break;
    case M_MIN: r = a < b ? a : b; break;
    case M_MAX: r = a > b ? a : b; break;
    case M_SECOND: r = b; break;
    default: r = a;
  }
  return cast_to(num_i(r), s.pcode);
}

// One edge's contribution in the accumulator type: the multiply, cast to
// the semiring's dtype, then to OT.
template <class OT, class S>
__device__ __forceinline__ OT contrib(const S& s, int64_t ve, int64_t xi) {
  return out_of<OT>(cast_to(multiply(s, ve, xi), s.scode));
}

// -- monoids ------------------------------------------------------------------

template <class T> struct Lim;
template <> struct Lim<int32_t> {
  __device__ static int32_t hi() { return INT_MAX; }
  __device__ static int32_t lo() { return INT_MIN; }
};
template <> struct Lim<long long> {
  __device__ static long long hi() { return LLONG_MAX; }
  __device__ static long long lo() { return LLONG_MIN; }
};
template <> struct Lim<float> {
  __device__ static float hi() { return INFINITY; }
  __device__ static float lo() { return -INFINITY; }
};
template <> struct Lim<double> {
  __device__ static double hi() { return (double)INFINITY; }
  __device__ static double lo() { return -(double)INFINITY; }
};

template <class OT>
__device__ __forceinline__ OT ident(int add) {
  if (add == A_MIN) return Lim<OT>::hi();
  if (add == A_MAX || add == A_ANY) return Lim<OT>::lo();
  return (OT)0;  // plus, or
}

// Where a dense reduce starts.  The reference reduces an ELL row, and
// reduce_scalar the whole capacity, with a plain max for 'or': only the
// neutralised padding entries (the identity 0) clamp it, so these reduces
// start below every value and take the identity from the padding itself.
template <class OT>
__device__ __forceinline__ OT start(int add) {
  return add == A_OR ? Lim<OT>::lo() : ident<OT>(add);
}

template <class T>
__device__ __forceinline__ T add_wrap(T a, T b) { return a + b; }
template <>
__device__ __forceinline__ int32_t add_wrap<int32_t>(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
template <>
__device__ __forceinline__ long long add_wrap<long long>(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
// Float sums round each addition: never merged with the product into a
// fused multiply-add, so a compile-time spec gives the dynamic spec's bits.
template <>
__device__ __forceinline__ float add_wrap<float>(float a, float b) {
  return __fadd_rn(a, b);
}
template <>
__device__ __forceinline__ double add_wrap<double>(double a, double b) {
  return __dadd_rn(a, b);
}

template <class T>
__device__ __forceinline__ bool is_nan(T v) { return v != v; }

template <class OT>
__device__ __forceinline__ OT combine(int add, OT a, OT b) {
  if (add == A_PLUS) return add_wrap<OT>(a, b);
  if (is_nan(a) || is_nan(b)) return is_nan(a) ? a : b;
  if (add == A_MIN) return a < b ? a : b;
  return a > b ? a : b;  // max, or, any
}

// -- masks --------------------------------------------------------------------

template <class S>
__device__ __forceinline__ bool keep_out(const S& s, int64_t r) {
  if (s.omask == nullptr) return true;
  const bool nz = ld_nz(s.omask, s.mcode, r);
  return s.complement ? !nz : nz;
}

template <class S>
__device__ __forceinline__ bool edge_on(const S& s, int64_t e) {
  return s.ecode == T_NONE || s.emask == nullptr || ld_nz(s.emask, s.ecode, e);
}

// -- order-preserving images for float min / max atomics ---------------------
// a < b as floats iff image(a) < image(b) as ints; NaN takes the extreme key
// that wins the reduction (INT_MIN for min, INT_MAX for max), which no other
// value takes, so the decode gives NaN back.

__device__ __forceinline__ int32_t ord32(float v, bool for_min) {
  if (isnan(v)) return for_min ? INT_MIN : INT_MAX;
  const int32_t b = __float_as_int(v);
  return b >= 0 ? b : (b ^ 0x7fffffff);
}

__device__ __forceinline__ float of_ord32(int32_t o) {
  if (o == INT_MIN || o == INT_MAX) return NAN;
  return __int_as_float(o >= 0 ? o : (o ^ 0x7fffffff));
}

__device__ __forceinline__ long long ord64(double v, bool for_min) {
  if (isnan(v)) return for_min ? LLONG_MIN : LLONG_MAX;
  const long long b = __double_as_longlong(v);
  return b >= 0 ? b : (b ^ 0x7fffffffffffffffLL);
}

__device__ __forceinline__ double of_ord64(long long o) {
  if (o == LLONG_MIN || o == LLONG_MAX) return (double)NAN;
  return __longlong_as_double(o >= 0 ? o : (o ^ 0x7fffffffffffffffLL));
}

// -- compile-time specs and the dispatch over them ----------------------------

template <int C> struct OType;
template <> struct OType<T_I32> { using type = int32_t; };
template <> struct OType<T_I64> { using type = long long; };
template <> struct OType<T_F32> { using type = float; };
template <> struct OType<T_F64> { using type = double; };

// The float32 semirings (x, values, product and output float32), the
// reduces of float32 values alone, and plus_pair over int32 x (bool
// product, int32 semiring) into an OC output; E the edge mask's type.
template <int MUL, int ADD, int E>
using F32Spec = Fixed<MUL, ADD, T_F32, T_F32, T_F32, T_F32, T_F32, E>;
template <int ADD, int E>
using F32Value = Fixed<M_VALUE, ADD, T_F32, T_F32, T_NONE, T_F32, T_F32, E>;
template <int OC, int E>
using PlusPairI32 = Fixed<M_PAIR, A_PLUS, T_BOOL, T_NONE, T_I32, T_I32, OC, E>;

template <class... Specs> struct SpecList {};

template <class A, class B> struct Cat;
template <class... X, class... Y>
struct Cat<SpecList<X...>, SpecList<Y...>> {
  using type = SpecList<X..., Y...>;
};

// Call c.run<S, OT>() with the dynamic spec and the output type of `ocode`.
template <class Call>
int run_dynamic(int ocode, const Call& c) {
  switch (ocode) {
    case T_I32: return c.template run<Sem, int32_t>();
    case T_I64: return c.template run<Sem, long long>();
    case T_F32: return c.template run<Sem, float>();
    case T_F64: return c.template run<Sem, double>();
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class Call>
int dispatch(int64_t, int ocode, const Call& c, SpecList<>) {
  return run_dynamic(ocode, c);
}

// Call c.run<S, OT>() with the first spec of the list that matches the
// code, else with the dynamic spec.
template <class Call, class S, class... Rest>
int dispatch(int64_t code, int ocode, const Call& c, SpecList<S, Rest...>) {
  if (S::matches(code)) return c.template run<S, typename OType<S::ocode>::type>();
  return dispatch(code, ocode, c, SpecList<Rest...>{});
}

}  // namespace fk
