/* Minimal netcdf.h covering the subset of the netCDF-C 4.9.0 API that
 * the reference model uses, so it can be linked against the system
 * libnetcdf.so.19 (which ships without development headers in this
 * image).  Constants are the stable netCDF ABI values (netcdf-c
 * include/netcdf.h, v4.9.0).  Used only by the golden-parity harness
 * (parity/build_ref.sh); the framework itself reads netCDF through
 * its own pure-Python HDF5 reader (mptrac_tpu/io/hdf5.py). */
#ifndef PARITY_NETCDF_H
#define PARITY_NETCDF_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef int nc_type;

#define NC_NAT      0
#define NC_BYTE     1
#define NC_CHAR     2
#define NC_SHORT    3
#define NC_INT      4
#define NC_FLOAT    5
#define NC_DOUBLE   6

#define NC_NOERR    0
#define NC_NOWRITE  0x0000
#define NC_WRITE    0x0001
#define NC_CLOBBER  0x0000
#define NC_SHARE    0x0800
#define NC_NETCDF4  0x1000

#define NC_GLOBAL   (-1)
#define NC_MAX_DIMS 1024
#define NC_MAX_NAME 256
#define NC_UNLIMITED 0L

#define NC_INDEPENDENT 0
#define NC_COLLECTIVE  1

#define NC_NOQUANTIZE          0
#define NC_QUANTIZE_BITGROOM   1
#define NC_QUANTIZE_GRANULARBR 2
#define NC_QUANTIZE_BITROUND   3

extern const char *nc_strerror(int ncerr);

extern int nc_open(const char *path, int mode, int *ncidp);
extern int nc_create(const char *path, int cmode, int *ncidp);
extern int nc_close(int ncid);
extern int nc_enddef(int ncid);

extern int nc_def_dim(int ncid, const char *name, size_t len,
                      int *idp);
extern int nc_inq_dimid(int ncid, const char *name, int *idp);
extern int nc_inq_dimlen(int ncid, int dimid, size_t *lenp);

extern int nc_def_var(int ncid, const char *name, nc_type xtype,
                      int ndims, const int *dimidsp, int *varidp);
extern int nc_def_var_deflate(int ncid, int varid, int shuffle,
                              int deflate, int deflate_level);
extern int nc_def_var_filter(int ncid, int varid, unsigned int id,
                             size_t nparams,
                             const unsigned int *parms);
extern int nc_def_var_quantize(int ncid, int varid, int quantize_mode,
                               int nsd);
extern int nc_inq_varid(int ncid, const char *name, int *varidp);
extern int nc_inq_varndims(int ncid, int varid, int *ndimsp);
extern int nc_inq_vardimid(int ncid, int varid, int *dimidsp);
extern int nc_var_par_access(int ncid, int varid, int par_access);

extern int nc_get_att_float(int ncid, int varid, const char *name,
                            float *ip);
extern int nc_get_att_short(int ncid, int varid, const char *name,
                            short *ip);
extern int nc_put_att_text(int ncid, int varid, const char *name,
                           size_t len, const char *op);

extern int nc_get_var_double(int ncid, int varid, double *ip);
extern int nc_get_var_float(int ncid, int varid, float *ip);
extern int nc_get_var_short(int ncid, int varid, short *ip);

extern int nc_put_var_double(int ncid, int varid, const double *op);
extern int nc_put_var_float(int ncid, int varid, const float *op);
extern int nc_put_var_int(int ncid, int varid, const int *op);
extern int nc_put_vara_double(int ncid, int varid,
                              const size_t *startp,
                              const size_t *countp, const double *op);
extern int nc_put_vara_float(int ncid, int varid, const size_t *startp,
                             const size_t *countp, const float *op);
extern int nc_put_vara_int(int ncid, int varid, const size_t *startp,
                           const size_t *countp, const int *op);

#ifdef __cplusplus
}
#endif

#endif /* PARITY_NETCDF_H */
